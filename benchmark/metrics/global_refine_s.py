"""global_refine_s: seconds of the EigenSNP global PCA and the
refinement with its final eigensolve and loadings, the program's
`stage_seconds` "global_pca" + "refinement_finalize"."""

from benchmark.harness import per_job


def read(win):
    return per_job(win, lambda r: r["stage_seconds"]["global_pca"]
                   + r["stage_seconds"]["refinement_finalize"])

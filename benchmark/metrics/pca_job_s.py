"""pca_job_s: mean wall seconds of one randomized-PCA job, the window's
seconds over the jobs it completed."""

from benchmark.harness import mean_job_s


def read(win):
    return mean_job_s(win)

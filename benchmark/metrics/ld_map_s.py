"""ld_map_s: seconds a job spends parsing the LD-block file and mapping
the kept SNPs to its blocks, the program's two `gp.prepare.ld_map`
spans, whose stamps the program reports as `stage_seconds["ld_map"]`;
read in traced runs."""

from benchmark.harness import per_job


def read(win):
    if win.trace is None:
        return None
    return per_job(win, lambda r: r["stage_seconds"]["ld_map"])

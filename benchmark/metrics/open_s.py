"""open_s: seconds a job spends opening the PLINK fileset (the BIM and
FAM parse), the program's span `gp.prepare.open`, whose stamps the
program reports as `stage_seconds["open"]`; read in traced runs."""

from benchmark.harness import per_job


def read(win):
    if win.trace is None:
        return None
    return per_job(win, lambda r: r["stage_seconds"]["open"])

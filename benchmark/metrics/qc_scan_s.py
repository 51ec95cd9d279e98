"""qc_scan_s: seconds a job spends in the SNP-QC scan (host or device)
and its merge, the program's span `gp.prepare.qc_scan`, whose stamps the
program reports as `stage_seconds["qc_scan"]`; read in traced runs."""

from benchmark.harness import per_job


def read(win):
    if win.trace is None:
        return None
    return per_job(win, lambda r: r["stage_seconds"]["qc_scan"])

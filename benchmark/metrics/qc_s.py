"""qc_s: seconds a job spends in `prepare_data` (sample QC, the SNP QC
scan, the LD mapping), by the benchmark's clock around the call."""

from benchmark.harness import per_job


def read(win):
    return per_job(win, lambda r: r["qc_s"])

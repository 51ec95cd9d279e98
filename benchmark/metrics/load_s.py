"""load_s: seconds a job spends loading the matrix into its container,
the program's `stage_seconds["matrix_load"]`."""

from benchmark.harness import per_job


def read(win):
    return per_job(win, lambda r: r["stage_seconds"]["matrix_load"])

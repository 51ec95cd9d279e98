"""stages12_s: seconds of EigenSNP stages 1-2 (the local block PCAs and
the condensed matrix), the program's `stage_seconds["stages_1_2"]`."""

from benchmark.harness import per_job


def read(win):
    return per_job(win, lambda r: r["stage_seconds"]["stages_1_2"])

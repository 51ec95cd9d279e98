"""pass_roofline.pca: percent of a job's device time that the least time
of its matrix passes makes up.  The passes are the traffic file's
`passes` (pass name, count); each pass's least time is the larger of its
operations over the chip's peak and its bytes over the memory bandwidth
(`roofline/<pass>.py`, `roofline/peaks.json`), at the configuration's
sizes with the rows of one rank.  No device time, no reading."""

from benchmark import roofline
from benchmark.harness import core_ms


def read(win):
    ms = core_ms(win)
    if ms is None:
        return None
    return 100.0 * roofline.job_bound_ms(win.cell.config, win.cell.traffic,
                                         win.world) / ms

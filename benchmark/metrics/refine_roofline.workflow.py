"""refine_roofline.workflow: percent of the device time under the
program's `gp.pass.*` spans (`refine_pass_ms.workflow`) that the least
time of the refinement's passes makes up.

The passes are the configuration's `refine_work` (pass name, count; its
basis width `ell`), each pass's least time that of `roofline/<pass>.py`
(`roofline.pass_bound_s`), over d = the rows the jobs kept, n = the
configuration's samples and k = its `k_global`: every quantity from the
configuration and the jobs' records, none from the program's code, so
the same work is counted whatever runs it.  No device time, no reading.
"""

from benchmark import roofline
from benchmark.spans import of_window


def least_ms(config: dict, d: int) -> float:
    """The least milliseconds of one job's refinement passes over d rows."""
    work = config["refine_work"]
    n = config["sizes"]["n_samples"]
    k = config["eigensnp"]["k_global"]
    return 1e3 * sum(count * roofline.pass_bound_s(name, d, n, work["ell"], k)
                     for name, count in work["passes"])


def read(win):
    ms = of_window(win).get("pass_device_ms.pca")
    if ms is None or "refine_work" not in win.cell.config or not win.records:
        return None
    d = sum(len(r["kept"]) for r in win.records) / len(win.records)
    return 100.0 * least_ms(win.cell.config, round(d)) / ms

"""refine_pass_ms.workflow: device milliseconds a job of the operations
launched under the program's `gp.pass.*` spans, over the traced window
(`spans.span_metrics`): in the EigenSNP job, the refinement's passes of
`pca_core`, the only ones it runs.  No device time, no reading."""

from benchmark.spans import of_window


def read(win):
    return of_window(win).get("pass_device_ms.pca")

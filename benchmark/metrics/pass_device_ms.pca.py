"""pass_device_ms.pca: device milliseconds a job of the operations
launched under the program's `gp.pass.*` spans (its matrix passes with
their all-reduce), over the traced window (`spans.span_metrics`); no
device time, no reading."""

from benchmark.spans import of_window


def read(win):
    return of_window(win).get("pass_device_ms.pca")

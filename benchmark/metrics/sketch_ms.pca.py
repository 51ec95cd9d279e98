"""sketch_ms.pca: host milliseconds a job spends drawing the Gaussian
sketch and uploading it, the program's `gp.pca.sketch` spans over the
traced window (`spans.span_metrics`)."""

from benchmark.spans import of_window


def read(win):
    return of_window(win).get("sketch_ms.pca")

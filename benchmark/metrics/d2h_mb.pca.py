"""d2h_mb.pca: megabytes (10^6 bytes) a job brings from the device to the
host through the program's `to_host`, its counter `COUNTS["d2h_bytes"]`
over the window, in a traced window holding `gp.pca` spans."""

from benchmark.spans import of_window


def read(win):
    return of_window(win).get("d2h_mb.pca")

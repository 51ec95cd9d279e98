"""kernel_roofline.pca: percent of the device time under the program's
`gp.pass.*` spans (`pass_device_ms.pca`) that the least time of the
job's matrix passes makes up (the traffic file's `passes`,
`roofline/`); no device time, no reading."""

from benchmark.spans import of_window


def read(win):
    return of_window(win).get("kernel_roofline.pca")

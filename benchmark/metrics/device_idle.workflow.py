"""device_idle.workflow: percent of the traced window that no device
operation (kernel, memcpy, memset) covers, over the union of their
intervals; averaged over the ranks."""

from benchmark.harness import idle_percent


def read(win):
    return idle_percent(win)

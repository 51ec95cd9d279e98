"""core_device_ms.pca: device milliseconds a job, the self device time
of every CUDA row of the trace (kernels, memcpy, memset) summed over the
traced window, over its jobs; rank 0's."""

from benchmark.harness import core_ms


def read(win):
    return core_ms(win)

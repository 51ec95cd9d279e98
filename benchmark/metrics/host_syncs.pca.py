"""host_syncs.pca: the host's synchronous CUDA calls a job
(`cudaStreamSynchronize`, `cudaDeviceSynchronize`,
`cudaEventSynchronize`, a synchronous `cudaMemcpy`) made inside the
program's `gp.pca` spans, over the traced window."""

from benchmark.spans import of_window


def read(win):
    return of_window(win).get("host_syncs.pca")

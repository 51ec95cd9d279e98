"""block_fetch_kernel.workflow: EigenSNP stage 1-2 block batches a job
that the card's kernel built (`kernels.standardize_runs`), the program's
counter `COUNTS["block_fetch_kernel"]` over the window (each
`fetch_blocks_device` call the kernel serves once); a program without the
counter, no reading."""

from benchmark.harness import count_per_job


def read(win):
    return count_per_job(win, "block_fetch_kernel")

"""passes_2d.workflow: matrix passes a job runs in the container's 2-D
mode, the program's counter `COUNTS["passes_2d"]` over the window (each
exact pass, q8 pass, Rayleigh-Ritz Gram and right product once); a
program without the counter, no reading."""

from benchmark.harness import count_per_job


def read(win):
    return count_per_job(win, "passes_2d")

"""table_rows_loop: .bim and .fam rows a job parses by the program's
Python line loop (`io/bed.py`), which the native pass hands a table it
cannot judge, its counter `COUNTS["table_rows_loop"]` over the window."""

from benchmark.harness import count_per_job


def read(win):
    return count_per_job(win, "table_rows_loop")

"""table_rows_native: .bim and .fam rows a job parses by the program's
native pass (`io/native.py` `parse_table_native`), its counter
`COUNTS["table_rows_native"]` over the window."""

from benchmark.harness import count_per_job


def read(win):
    return count_per_job(win, "table_rows_native")

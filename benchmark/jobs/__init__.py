"""Job kinds, one module each, named by a traffic file's `job`.

A module exposes `setup(ctx) -> state` (the cell's inputs made from the
seed and the program's state built from them), `run(state, index) ->
record` (one job through the program: `index` -1 is the warm-up),
`release(state)` (free the program's state once the window has closed)
and `check(state, records) -> list of per-job readings` (the plain
reference against what the timed jobs produced).
"""

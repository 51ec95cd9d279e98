"""The least time of a job's matrix passes, from shapes alone.

A pass file `roofline/<pass>.py` gives `work(d, n, ell, k) -> (ops,
bytes, peak)`: the operations and bytes the pass needs over a (d x n)
matrix with a basis of `ell` columns and `k` components, whatever
implements it, and the name of the peak its operations run at
(`peaks.json`).  A product costs 2 d n L operations, L being the
columns it needs (k + the oversamples for the basis, k for the
loadings: the lanes a program fills beyond them are its choice and are
not counted).  Bytes are counted once each: the packed genotypes (d
ceil(n / 4)), the operands and the outputs in float32.  A pass's least
time is the larger of its operations over the peak and its bytes over
the memory bandwidth.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def peaks() -> dict:
    with open(HERE / "peaks.json") as fh:
        return json.load(fh)


def pass_bound_s(name: str, d: int, n: int, ell: int, k: int) -> float:
    from benchmark.harness import load_module

    ops, nbytes, peak = load_module(HERE / f"{name}.py").work(d, n, ell, k)
    p = peaks()
    return max(ops / p[peak], nbytes / p["hbm_bytes_per_s"])


def job_bound_ms(config: dict, traffic: dict, world: int = 1) -> float:
    """The least milliseconds of one job's passes (the traffic file's
    `passes`), over the rows one of `world` ranks holds."""
    d = -(-config["sizes"]["n_snps"] // world)
    n = config["sizes"]["n_samples"]
    k = config["pca"]["k"]
    ell = k + config["pca"]["n_oversamples"]
    return 1e3 * sum(count * pass_bound_s(name, d, n, ell, k)
                     for name, count in traffic["passes"])

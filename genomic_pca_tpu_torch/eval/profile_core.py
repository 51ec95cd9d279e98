"""Where the time of the packed randomized-PCA core goes, on one GPU.

    python -m genomic_pca_tpu_torch.eval.profile_core [--out DIR] [--streamed]

At the main path's shape (262,144 SNPs x 2,048 samples, k = 10, a
128-wide sketch, 4 power iterations), over random PLINK bytes made from a
fixed seed (the core's time does not depend on the genotypes), it times
on the host clock, around work that ends in `torch.cuda.synchronize()`:

- `from_packed_rows` + `streamed_pca(compute_loadings=True)`, split into
  construction and PCA, over 10 warm runs after one cold run;
- `pca_core` alone on a resident matrix, over 10 runs;

then traces one `pca_core` with torch.profiler and prints the device time
by kernel and the busy share (device time / traced wall).  With
`--streamed` it also times `streamed_pca(compute_loadings=True)` over a
host-streamed container of the same bytes in strips of 2,048 rows (the
streamed 1-D main path: per strip kernels 1, 2 and 4), over 3 warm runs
after one cold run, with the seconds of each of its passes.  Prints the
card's `nvidia-smi` name and power limit; writes `summary.json` and the
profiler table under `--out` when given.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROWS, SAMPLES, K, RUNS = 262_144, 2048, 10, 10
STRIP, STREAMED_RUNS = 2048, 3


def _stats(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "q1": q[0], "q3": q[2], "n": len(xs)}


def _fmt(name, s):
    return (f"{name}: median {s['median']:.4f} s (min {s['min']:.4f}, max "
            f"{s['max']:.4f}, quartiles {s['q1']:.4f} / {s['q3']:.4f}, "
            f"{s['n']} runs)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="genomic_pca_tpu_torch.eval.profile_core")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for summary.json and the profiler table")
    ap.add_argument("--streamed", action="store_true",
                    help="also time the streamed 1-D main path")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_core needs a CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    from torch.profiler import ProfilerActivity, profile

    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix
    from genomic_pca_tpu_torch.utils.rng import normal

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)

    device = torch.device("cuda")
    d, n, k = ROWS, SAMPLES, K
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, size=(d, -(-n // 4)), dtype=np.uint8)
    mean = rng.uniform(0.2, 1.8, size=d).astype(np.float32)
    std = rng.uniform(0.4, 0.9, size=d).astype(np.float32)

    def e2e():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm = ShardedMatrix.from_packed_rows(packed, mean, std, n, device=device)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        streamed_pca(sm, k=k, n_power_iter=4, seed=7, compute_loadings=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return t2 - t0, t1 - t0, t2 - t1

    cold = e2e()
    print(f"cold run (kernel build included): total {cold[0]:.4f} s, "
          f"construction {cold[1]:.4f} s, streamed_pca {cold[2]:.4f} s", flush=True)
    warm = [e2e() for _ in range(RUNS)]
    summary = {
        "device": smi, "rows": d, "samples": n, "k": k,
        "cold_s": cold[0],
        "total_s": _stats([w[0] for w in warm]),
        "construction_s": _stats([w[1] for w in warm]),
        "streamed_pca_s": _stats([w[2] for w in warm]),
    }
    print(_fmt("from_packed_rows + streamed_pca", summary["total_s"]))
    print(_fmt("  from_packed_rows", summary["construction_s"]))
    print(_fmt("  streamed_pca", summary["streamed_pca_s"]))

    sm = ShardedMatrix.from_packed_rows(packed, mean, std, n, device=device)
    b = normal((n, 128), 7, "rfit_sketch", device)
    core = []
    for _ in range(RUNS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm.pca_core(b, 4, k)
        torch.cuda.synchronize()
        core.append(time.perf_counter() - t0)
    summary["pca_core_s"] = _stats(core)
    print(_fmt("pca_core", summary["pca_core_s"]))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm.pca_core(b, 4, k)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    rows = []
    for ev in prof.key_averages():
        if not str(ev.device_type).endswith("CUDA"):
            continue
        if ev.self_device_time_total > 0:
            rows.append((ev.key, ev.count, ev.self_device_time_total / 1e3))
    rows.sort(key=lambda r: -r[2])
    device_ms = sum(r[2] for r in rows)
    summary["traced_pca_core_ms"] = traced_ms
    summary["device_ms"] = device_ms
    summary["busy_share"] = device_ms / traced_ms
    summary["kernels"] = [{"name": r[0], "count": r[1], "ms": r[2]} for r in rows]
    print(f"traced pca_core: wall {traced_ms:.3f} ms, device time "
          f"{device_ms:.3f} ms, busy share {device_ms / traced_ms:.3f}")
    for name, count, ms in rows:
        print(f"  {ms:9.3f} ms  x{count:<3d} {name[:100]}")
    if args.streamed:
        summary.update(streamed(packed, mean, std, n, k, device))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
        (args.out / "key_averages.txt").write_text(
            prof.key_averages().table(sort_by="self_device_time_total",
                                      row_limit=60))
    return 0


def streamed(packed, mean, std, n, k, device) -> dict:
    """Wall of `streamed_pca` over a host-streamed container of `packed`
    in STRIP-row strips, and the seconds of each pass of the last run."""
    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix

    d = packed.shape[0]
    n_strips = -(-d // STRIP)

    def source(i):
        lo, hi = i * STRIP, min((i + 1) * STRIP, d)
        return packed[lo:hi], mean[lo:hi], std[lo:hi]

    walls, passes = [], []
    for _ in range(1 + STREAMED_RUNS):
        sm = StreamingMatrix(source, n_strips, d, n, STRIP, packed=True,
                             device=device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        streamed_pca(sm, k=k, n_power_iter=4, seed=7, compute_loadings=True)
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        passes = [(t["pass"], t["seconds"]) for t in sm.pass_log]
    print(f"streamed 1-D, {n_strips} strips of {STRIP} rows: cold run "
          f"{walls[0]:.4f} s")
    out = {"streamed_s": _stats(walls[1:]), "streamed_passes_s": passes}
    print(_fmt("streamed_pca (streamed)", out["streamed_s"]))
    print("  passes of the last run: " + ", ".join(f"{p} {s:.4f} s" for p, s in passes))
    return out


if __name__ == "__main__":
    sys.exit(main())

"""Where the time of the packed randomized-PCA core goes, on one GPU.

    python -m genomic_pca_tpu_torch.eval.profile_core [--out DIR] [--streamed] [--2d]

At the main path's shape (262,144 SNPs x 2,048 samples, k = 10, a
128-wide sketch, 4 power iterations), over random PLINK bytes made from a
fixed seed (the core's time does not depend on the genotypes), it times
on the host clock, around work that ends in `torch.cuda.synchronize()`:

- `from_packed_rows` + `streamed_pca(compute_loadings=True)`, split into
  construction and PCA, over 10 warm runs after one cold run;
- the core alone (`models.pca.pca_core`) on a resident matrix, over 10
  runs;

then traces one `pca_core` with torch.profiler and prints the device time
by kernel and the busy share (device time / traced wall).  With `--2d`
it does the same for the 2-D core at 131,072 x 16,384 (kernels 5-8).
With `--streamed` it also times `streamed_pca(compute_loadings=True)`
over a host-streamed container of the 1-D bytes in strips of 2,048 rows
(the streamed 1-D main path: per strip kernels 1, 2 and 4), over 3 warm
runs after one cold run, with the seconds of each of its passes, and
traces one exact streamed pass through `utils/profiling.maybe_trace` (the
`--profile-dir` trace): its wall, the device time of its kernels and
copies, and the busy share.  Prints the card's `nvidia-smi` name and
power limit; writes `summary.json`, the profiler tables and the streamed
pass's Chrome trace under `--out` when given.  Exits 1 without a CUDA
device.
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
ROWS_2D, SAMPLES_2D = 131_072, 16_384
STRIP, STREAMED_RUNS = 2048, 3


def _stats(xs):
    q = statistics.quantiles(xs, n=4)
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs),
            "q1": q[0], "q3": q[2], "n": len(xs)}


def _fmt(name, s):
    return (f"{name}: median {s['median']:.4f} s (min {s['min']:.4f}, max "
            f"{s['max']:.4f}, quartiles {s['q1']:.4f} / {s['q3']:.4f}, "
            f"{s['n']} runs)")


def _random_packed(d, n, seed=0):
    """Random PLINK bytes and moments (the core's time does not depend on
    the genotypes)."""
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=(d, -(-n // 4)), dtype=np.uint8),
            rng.uniform(0.2, 1.8, size=d).astype(np.float32),
            rng.uniform(0.4, 0.9, size=d).astype(np.float32))


def core(d, n, k, device, runs, tag):
    """Warm walls of from_packed_rows + streamed_pca and of pca_core at
    (d, n), then one traced pca_core: (summary, profiler)."""
    from torch.profiler import ProfilerActivity, profile

    from genomic_pca_tpu_torch.models.pca import pca_core, streamed_pca
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix
    from genomic_pca_tpu_torch.utils.rng import normal

    packed, mean, std = _random_packed(d, n)

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
    print(f"[{tag}] {d} x {n}: cold run (kernel build included): total "
          f"{cold[0]:.4f} s, construction {cold[1]:.4f} s, streamed_pca "
          f"{cold[2]:.4f} s", flush=True)
    warm = [e2e() for _ in range(runs)]
    summary = {
        "rows": d, "samples": n, "k": k, "cold_s": cold[0],
        "total_s": _stats([w[0] for w in warm]),
        "construction_s": _stats([w[1] for w in warm]),
        "streamed_pca_s": _stats([w[2] for w in warm]),
    }
    print(_fmt(f"[{tag}] from_packed_rows + streamed_pca", summary["total_s"]))
    print(_fmt(f"[{tag}]   from_packed_rows", summary["construction_s"]))
    print(_fmt(f"[{tag}]   streamed_pca", summary["streamed_pca_s"]))

    sm = ShardedMatrix.from_packed_rows(packed, mean, std, n, device=device)
    print(f"[{tag}] container mode {sm.mode}")
    b = normal((n, 128), 7, "rfit_sketch", device)
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca_core(sm, b, 4, k)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    summary["pca_core_s"] = _stats(times)
    print(_fmt(f"[{tag}] pca_core", summary["pca_core_s"]))

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pca_core(sm, b, 4, k)
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
    print(f"[{tag}] traced pca_core: wall {traced_ms:.3f} ms, device time "
          f"{device_ms:.3f} ms, busy share {device_ms / traced_ms:.3f}")
    for name, count, ms in rows:
        print(f"  {ms:9.3f} ms  x{count:<3d} {name[:100]}")
    return summary, prof


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="genomic_pca_tpu_torch.eval.profile_core")
    ap.add_argument("--out", type=Path, default=None,
                    help="directory for summary.json, the profiler tables and "
                         "the streamed pass's trace")
    ap.add_argument("--streamed", action="store_true",
                    help="also time and trace the streamed 1-D main path")
    ap.add_argument("--2d", dest="two_d", action="store_true",
                    help="also profile the 2-D core at 131,072 x 16,384")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_core needs a CUDA device (torch.cuda.is_available() is "
              "False)", file=sys.stderr)
        return 1

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"nvidia-smi: {smi}", flush=True)

    device = torch.device("cuda")
    summary, prof = core(ROWS, SAMPLES, K, device, RUNS, "1-D")
    summary["device"] = smi
    profs = {"key_averages.txt": prof}
    if args.two_d:
        summary["2d"], profs["key_averages_2d.txt"] = core(
            ROWS_2D, SAMPLES_2D, K, device, 3, "2-D")
    if args.streamed:
        trace_dir = (args.out if args.out is not None else Path("build")) / "streamed_trace"
        summary.update(streamed(*_random_packed(ROWS, SAMPLES), SAMPLES, K, device,
                                trace_dir))
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
        (args.out / "summary.json").write_text(json.dumps(summary, indent=1))
        for name, p in profs.items():
            (args.out / name).write_text(
                p.key_averages().table(sort_by="self_device_time_total", row_limit=60))
    return 0


def streamed(packed, mean, std, n, k, device, trace_dir: Path) -> dict:
    """Wall of `streamed_pca` over a host-streamed container of `packed`
    in STRIP-row strips, the seconds of each pass of the last run, and
    one exact pass traced through `maybe_trace` into `trace_dir`."""
    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix
    from genomic_pca_tpu_torch.utils.profiling import maybe_trace

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

    b = torch.randn((n, 128), device=device) / n ** 0.5
    sm.gram_apply(b)  # warm
    with maybe_trace(str(trace_dir), device):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm.gram_apply(b)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    events = json.loads((trace_dir / "trace.rank0.json").read_text())["traceEvents"]
    by_cat = {}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset"):
            by_cat[ev["cat"]] = by_cat.get(ev["cat"], 0.0) + ev.get("dur", 0) / 1e3
    kernel_ms = by_cat.get("kernel", 0.0)
    out["traced_streamed_pass"] = {"wall_ms": wall_ms, "device_ms_by_category": by_cat,
                                   "kernel_busy_share": kernel_ms / wall_ms}
    print(f"traced streamed gram pass ({n_strips} strips): wall {wall_ms:.3f} ms; "
          f"device ms by category {by_cat}; kernel busy share "
          f"{kernel_ms / wall_ms:.3f}; trace in {trace_dir}")
    return out


if __name__ == "__main__":
    sys.exit(main())

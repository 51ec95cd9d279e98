"""The program's spans in a traced window: `reduce` turns the profiler's
events into what each `gp.` span of the program covered.

The program (`genomic_pca_tpu_torch/utils/profiling.py` `span`) marks
its layers with `record_function` ranges named `gp.<layer>...` whenever
a profiler runs.  For each span name `reduce` gives:

- `count`: the ranges of that name inside the window;
- `host_s`: the sum of their durations on the host;
- `device_s`: the device operations launched under them: a kernel,
  memcpy or memset is matched to the host call that launched it by its
  correlation id, and counted under the innermost `gp.` range that
  covers that call on its thread (or on the one thread that has ranges),
  so nested names do not count twice (a device operation whose launch is
  not in the trace counts under none);
- `idle_s`: the window's idle gaps (no device operation running),
  charged by overlap to the innermost `gp.` range covering them;
- `syncs`: the host's synchronous calls (`cudaStreamSynchronize`,
  `cudaDeviceSynchronize`, `cudaEventSynchronize`, a synchronous
  `cudaMemcpy`) made in them, each under the innermost range;

and, over the window, `syncs`: the synchronous calls inside `gp.pca`
ranges at any depth (`syncs_per_pca`: the fewest and the most in one
range), and `idle_in_spans_s`: the idle time that some `gp.` range
covers.  Times in the profiler's microseconds in, seconds out.

`python3 -m benchmark.spans --workload <cell> --seed <n> --seconds <s>`
runs a cell's traced run as `python3 -m benchmark.run ... --trace 1`
does and prints its result line with three more keys: `spans` (the
reduction of the window), `counts` (the program's
`utils.profiling.COUNTS` over the window) and `span_metrics` (the
per-layer readings the spans give a job).
"""

from __future__ import annotations

import argparse
import json
import sys
from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np
from torch.autograd import DeviceType

PREFIX = "gp."
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
              "cudaEventSynchronize", "cudaMemcpy")
# Host calls that put work on the device (`cudaLaunchKernel`,
# `cudaMemcpyAsync`, `cuLaunchKernel`, ...): names that start "cu".
LAUNCH_PREFIX = "cu"


def _is_cpu(e) -> bool:
    return e.device_type == DeviceType.CPU


def _segments(spans: List[tuple]) -> tuple:
    """The innermost range at each instant of one thread's properly
    nested ranges (start, end, index): (starts, ends, index) of
    non-overlapping segments, sorted."""
    out = []
    stack: List[tuple] = []
    at = None
    for s, e, i in sorted(spans, key=lambda t: (t[0], -t[1])):
        while stack and stack[-1][1] <= s:
            top = stack.pop()
            if at < top[1]:
                out.append((at, top[1], top[2]))
            at = max(at, top[1])
        if stack and at < s:
            out.append((at, s, stack[-1][2]))
        stack.append((s, e, i))
        at = s
    while stack:
        top = stack.pop()
        if at < top[1]:
            out.append((at, top[1], top[2]))
        at = max(at, top[1])
    if not out:
        return np.zeros(0), np.zeros(0), np.zeros(0, dtype=np.int64)
    arr = np.array(out, dtype=np.float64)
    return arr[:, 0], arr[:, 1], arr[:, 2].astype(np.int64)


def _covered(gaps: np.ndarray):
    """F(t): the length of the gaps (G, 2), disjoint, before t."""
    if not len(gaps):
        return lambda t: np.zeros_like(np.asarray(t, dtype=np.float64))
    gaps = gaps[np.argsort(gaps[:, 0])]
    gs, ge = gaps[:, 0], gaps[:, 1]
    cum = np.concatenate([[0.0], np.cumsum(ge - gs)])

    def f(t):
        t = np.asarray(t, dtype=np.float64)
        j = np.searchsorted(gs, t, side="right") - 1
        jc = np.clip(j, 0, len(gs) - 1)
        part = np.where(j >= 0, np.clip(t - gs[jc], 0.0, ge[jc] - gs[jc]), 0.0)
        return cum[np.clip(j, 0, None)] + part
    return f


def reduce(events, w0: float, w1: float, gaps) -> dict:
    """The `gp.` spans of the window [w0, w1] (profiler microseconds)
    with its idle gaps (G, 2): {"by_name": {name: {count, host_s,
    device_s, idle_s, syncs}}, "syncs": n, "syncs_per_pca": [lo, hi],
    "idle_in_spans_s": s}."""
    gaps = np.asarray(gaps, dtype=np.float64).reshape(-1, 2)
    gaps = np.stack([np.maximum(gaps[:, 0], w0), np.minimum(gaps[:, 1], w1)], axis=1)
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    covered = _covered(gaps)
    spans, launches, syncs, device = [], {}, [], []
    for e in events:
        s, t = e.time_range.start, e.time_range.end
        if _is_cpu(e):
            if e.name.startswith(PREFIX):
                if t > w0 and s < w1:
                    spans.append((max(s, w0), min(t, w1), e.name, e.thread))
                continue
            if e.name in SYNC_CALLS:
                syncs.append((s, e.thread))
            if e.name.startswith(LAUNCH_PREFIX):
                launches[e.id] = (s, e.thread)
        elif not e.is_user_annotation and not e.name.startswith((PREFIX, "bench.")):
            if t > w0 and s < w1:
                device.append((e.id, min(t, w1) - max(s, w0)))
    names = sorted({n for _, _, n, _ in spans})
    out = {n: {"count": 0, "host_s": 0.0, "device_s": 0.0, "idle_s": 0.0, "syncs": 0}
           for n in names}
    for s, t, n, _ in spans:
        out[n]["count"] += 1
        out[n]["host_s"] += (t - s) / 1e6
    idle_in = 0.0
    by_thread: Dict[int, List[tuple]] = defaultdict(list)
    for i, (s, t, _, th) in enumerate(spans):
        by_thread[th].append((s, t, i))
    segs = {}
    for th, lst in by_thread.items():
        ss, se, si = _segments(lst)
        segs[th] = (ss, se, si)
        idle = covered(se) - covered(ss)
        idle_in += float(idle.sum())
        for i, v in zip(si, idle):
            out[spans[i][2]]["idle_s"] += float(v) / 1e6
    only = next(iter(segs.values())) if len(segs) == 1 else None

    def innermost(t: float, thread) -> Optional[str]:
        got = segs.get(thread, only)
        if got is None:
            return None
        ss, se, si = got
        j = int(np.searchsorted(ss, t, side="right")) - 1
        return spans[si[j]][2] if j >= 0 and t < se[j] else None

    for corr, dur in device:
        hit = launches.get(corr)
        name = None if hit is None else innermost(*hit)
        if name is not None:
            out[name]["device_s"] += dur / 1e6
    for t, thread in syncs:
        name = innermost(t, thread)
        if name is not None:
            out[name]["syncs"] += 1
    pca = np.array(sorted((s, t) for s, t, n, _ in spans if n == "gp.pca"),
                   dtype=np.float64).reshape(-1, 2)
    per = np.zeros(len(pca), dtype=np.int64)
    if len(pca) and syncs:
        st = np.array([t for t, _ in syncs], dtype=np.float64)
        j = np.searchsorted(pca[:, 0], st, side="right") - 1
        inside = (j >= 0) & (st < pca[np.clip(j, 0, None), 1])
        np.add.at(per, j[inside], 1)
    return {"by_name": out, "syncs": int(per.sum()),
            "syncs_per_pca": [int(per.min()), int(per.max())] if len(per) else [],
            "idle_in_spans_s": idle_in / 1e6}


def idle_gaps(events, w0: float, w1: float) -> np.ndarray:
    """The window's idle gaps (G, 2) as `window_trace.summarize` finds
    them: where no device operation (kernel, memcpy, memset) runs."""
    from benchmark.window_trace import _union

    iv = []
    for e in events:
        if (not _is_cpu(e) and not e.is_user_annotation
                and not e.name.startswith((PREFIX, "bench."))):
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                iv.append((s, t))
    iv = np.array(sorted(iv), dtype=np.float64).reshape(-1, 2)
    _, gaps = _union(iv)
    if len(iv):
        gaps = np.concatenate([[[w0, iv[0, 0]]], gaps,
                               [[max(iv[:, 1].max(), w0), w1]]])
    else:
        gaps = np.array([[w0, w1]])
    return gaps[gaps[:, 1] > gaps[:, 0]]


def of_profile(prof) -> dict:
    """`reduce` over a stopped profiler's `bench.window`."""
    events = prof.events()
    win = next(e for e in events if e.name == "bench.window" and _is_cpu(e))
    w0, w1 = win.time_range.start, win.time_range.end
    return reduce(events, w0, w1, idle_gaps(events, w0, w1))


# ---- the per-layer readings the spans give a job ---------------------------
def span_metrics(sp: dict, counts: dict, n_jobs: int,
                 bound_ms: Optional[float]) -> dict:
    """The per-layer readings a job of the window has from its spans and
    the program's counts: the preparation's host seconds (`open_s`,
    `qc_scan_s`, `ld_map_s`), the sketch's host ms (`sketch_ms.pca`), the
    device ms under `gp.pass.*` (`pass_device_ms.pca`) and the passes'
    least time `bound_ms` over it (`kernel_roofline.pca`), the MB brought
    back (`d2h_mb.pca`) and the syncs in `gp.pca` (`host_syncs.pca`)."""
    by = sp["by_name"]
    if not n_jobs:
        return {}
    out = {}
    for metric, name in (("open_s", "gp.prepare.open"),
                         ("qc_scan_s", "gp.prepare.qc_scan"),
                         ("ld_map_s", "gp.prepare.ld_map")):
        if name in by:
            out[metric] = by[name]["host_s"] / n_jobs
    if "gp.pca.sketch" in by:
        out["sketch_ms.pca"] = 1e3 * by["gp.pca.sketch"]["host_s"] / n_jobs
    passes = sum(v["device_s"] for k, v in by.items() if k.startswith("gp.pass."))
    if passes > 0:
        out["pass_device_ms.pca"] = 1e3 * passes / n_jobs
        if bound_ms is not None:
            out["kernel_roofline.pca"] = 100.0 * bound_ms / out["pass_device_ms.pca"]
    if "gp.pca" in by:
        out["host_syncs.pca"] = sp["syncs"] / n_jobs
        if "d2h_bytes" in counts:
            out["d2h_mb.pca"] = counts["d2h_bytes"] / n_jobs / 1e6
    return out


def _program_counts():
    """The program's byte counter module, where the program has one."""
    try:
        from genomic_pca_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "COUNTS") else None


def traced_run(spec: dict, cell_name: str, seed: int, seconds: float, device: str,
               tmpdir: str, t_start: float, root=None) -> dict:
    """`harness.run_cell` traced, with the spans of its window reduced and
    the program's counts taken over the window (zeroed where the trace
    starts, read where it stops)."""
    from benchmark import harness
    from benchmark import window_trace as tracemod

    held: dict = {}
    start, stop = tracemod.start, tracemod.stop
    counter = _program_counts()

    def start_counting(dev):
        if counter is not None:
            counter.reset_counts()
        return start(dev)

    def stop_reducing(prof, dev, world):
        held["counts"] = dict(counter.COUNTS) if counter is not None else {}
        summary = stop(prof, dev, world)
        held["spans"] = of_profile(prof)
        return summary

    tracemod.start, tracemod.stop = start_counting, stop_reducing
    try:
        kw = {} if root is None else {"root": root}
        result = harness.run_cell(spec, cell_name, seed, seconds, True, device, tmpdir,
                                  t_start, **kw)
    finally:
        tracemod.start, tracemod.stop = start, stop
    cell = harness.load_cell(spec, cell_name, **kw)
    bound = None
    if "passes" in cell.traffic:
        from benchmark import roofline

        bound = roofline.job_bound_ms(cell.config, cell.traffic, cell.chips)
    result["spans"] = held["spans"]
    result["counts"] = held["counts"]
    result["span_metrics"] = span_metrics(held["spans"], held["counts"],
                                          result["attempted"], bound)
    return result


def main(argv=None) -> int:
    from benchmark import run

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.cache_env()
    import shutil
    import tempfile

    import torch

    from benchmark import harness

    spec = harness.load_json(harness.ROOT / "BENCHMARK.json")
    if harness.load_cell(spec, args.workload).chips != 1 or not torch.cuda.is_available():
        print("benchmark.spans: runs one-GPU cells on a machine with CUDA",
              file=sys.stderr)
        return 2
    tmpdir = tempfile.mkdtemp(prefix="bench-")
    try:
        result = traced_run(spec, args.workload, args.seed, args.seconds, "cuda",
                            tmpdir, run.T_START)
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

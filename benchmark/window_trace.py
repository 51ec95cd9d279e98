"""The traced window: torch.profiler over every job of the window, reduced
to what the per-layer metrics read.

Device operations are the profiler's CUDA events (kernels, memcpy,
memset), each with its interval.  The summary holds:

- `busy_s`: the length of the union of their intervals inside the
  window (averaged over the ranks), `window_s`: the window's length
  (the `bench.window` span);
- `device_s`: the sum of their durations (the self device time of the
  CUDA rows, as `key_averages` sums them), `nccl_s` that of the NCCL
  kernels;
- `breakdown`: the ten device operations that took most time, and the
  ten host operations under which the device stood idle longest (each
  idle gap charged to the shortest host event that covers its middle);
- `spans`: what each of the program's `gp.` spans covered in the window
  (`spans.reduce`, over the same idle gaps).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Optional

import numpy as np
import torch
from torch.autograd import DeviceType

from benchmark import spans

# The longest gaps attributed to a host operation.
GAPS_ATTRIBUTED = 2000


def start(device: torch.device):
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    prof._bench_window = torch.profiler.record_function("bench.window")
    prof._bench_window.__enter__()
    return prof


def _union(iv: np.ndarray) -> tuple:
    """(covered length, gaps (G, 2)) of intervals (K, 2) sorted by start."""
    if len(iv) == 0:
        return 0.0, np.zeros((0, 2))
    ends = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > ends[:-1]
    starts = iv[new, 0]
    idx = np.flatnonzero(new)
    seg_end = np.append(ends[idx[1:] - 1], ends[-1])
    covered = float((seg_end - starts).sum())
    gaps = np.stack([seg_end[:-1], starts[1:]], axis=1)
    return covered, gaps


def summarize(prof) -> dict:
    events = prof.events()
    win = [e for e in events if e.name == "bench.window" and e.device_type == DeviceType.CPU]
    w0, w1 = win[0].time_range.start, win[0].time_range.end
    # Device operations only: the GPU-side copies of record_function spans
    # (user annotations, such as "bench.job") are not work.
    dev = [e for e in events if e.device_type != DeviceType.CPU
           and not e.is_user_annotation and not e.name.startswith("bench.")]
    host = [e for e in events if e.device_type == DeviceType.CPU
            and e.name not in ("bench.window",)]
    by_name = defaultdict(float)
    iv = []
    nccl_us = 0.0
    for e in dev:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        dur = e.time_range.end - e.time_range.start
        by_name[e.name] += dur
        if "nccl" in e.name.lower():
            nccl_us += dur
        if t > s:
            iv.append((s, t))
    iv = np.array(sorted(iv), dtype=np.float64).reshape(-1, 2)
    busy_us, gaps = _union(iv)
    if len(iv):
        gaps = np.concatenate([[[w0, iv[0, 0]]], gaps, [[max(iv[:, 1].max(), w0), w1]]])
    else:
        gaps = np.array([[w0, w1]])
    gaps = gaps[gaps[:, 1] > gaps[:, 0]]
    idle_by_host = _attribute(gaps, host)
    top_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "window_s": (w1 - w0) / 1e6,
        "device_s": sum(by_name.values()) / 1e6,
        "nccl_s": nccl_us / 1e6,
        "n_device_events": len(dev),
        "breakdown": {
            "device_ops": [[k, v / 1e6] for k, v in top_ops],
            "idle_gaps": [[k, v / 1e6] for k, v in idle_by_host[:10]],
        },
        "spans": spans.reduce(events, w0, w1, gaps),
    }


def _attribute(gaps: np.ndarray, host) -> list:
    """Idle seconds by the host event covering each gap's middle."""
    if not len(gaps):
        return []
    order = np.argsort(gaps[:, 0] - gaps[:, 1])[:GAPS_ATTRIBUTED]
    gaps = gaps[order]
    hs = np.array([e.time_range.start for e in host], dtype=np.float64)
    he = np.array([e.time_range.end for e in host], dtype=np.float64)
    names = [e.name for e in host]
    out = defaultdict(float)
    for g0, g1 in gaps:
        mid = 0.5 * (g0 + g1)
        cover = np.flatnonzero((hs <= mid) & (he >= mid))
        name = "(no host event)" if not len(cover) else names[
            cover[np.argmin(he[cover] - hs[cover])]]
        out[name] += g1 - g0
    return sorted(out.items(), key=lambda kv: -kv[1])


def stop(prof, device: torch.device, world: int) -> Optional[dict]:
    prof._bench_window.__exit__(None, None, None)
    prof.__exit__(None, None, None)
    summary = summarize(prof)
    if world > 1:
        import torch.distributed as dist

        comm = device if dist.get_backend() == "nccl" else torch.device("cpu")
        t = torch.tensor([summary["busy_s"]], dtype=torch.float64, device=comm)
        dist.all_reduce(t)
        summary["busy_s"] = float(t.item()) / world
    return summary

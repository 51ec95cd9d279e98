"""The benchmark's general machinery, driven by `BENCHMARK.json` and the
files it names.

A cell (`workloads` entry) names a configuration, `configs/<name>.json`,
and a traffic mix, `traffic/<name>.json`, whose `job` names a job kind,
`jobs/<job>.py`.  Every metric is a reader, `metrics/<metric name>.py`,
with `read(window) -> float or None`; a cell reports the metrics whose
`workloads` list it (or that list none).  The limits of the numbers
that decide `correct` are `limits/<cell>.json`.

A run: set-up (the inputs made from the seed, the program's state built
from them, one warm-up job of the cell's own shapes), then a closed loop
of jobs, each starting when the last has ended, each timed from its
start to a `torch.cuda.synchronize()`; the window closes at the first
job end after `seconds`.  Over several ranks every rank runs every job
and rank 0 decides, after each job, whether the window goes on.  Then
the program's state is freed and the plain reference judges every job
of the window.
"""

from __future__ import annotations

import dataclasses
import gc
import importlib.util
import json
import sys
import time
from pathlib import Path
from typing import Callable, List, Optional

import numpy as np
import torch

from benchmark import window_trace as tracemod
from benchmark.reference import compare

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# A reading that is missing or not finite, as the result line shows it.
FAR = 1e300


def load_json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: Path):
    """A module from a file path: metric and roofline files are named by
    metric or pass names, which may hold dots."""
    if not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    rel = path.resolve().relative_to(HERE).with_suffix("")
    name = "benchmark._by_name." + "__".join(rel.parts).replace(".", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def metrics_of(spec: dict, cell_name: str, group: str) -> List[dict]:
    return [m for m in spec[group]
            if "workloads" not in m or cell_name in m["workloads"]]


def load_cell(spec: dict, cell_name: str, root: Path = ROOT) -> Cell:
    cells = {w["name"]: w for w in spec["workloads"]}
    if cell_name not in cells:
        raise KeyError(f"no workload {cell_name!r} in BENCHMARK.json "
                       f"(have {sorted(cells)})")
    w = cells[cell_name]
    conf = next(c for c in spec["configs"] if c["name"] == w["config"])
    return Cell(
        name=cell_name, chips=int(w["chips"]),
        config=load_json(root / conf["file"]),
        traffic=load_json(root / "benchmark" / "traffic" / f"{w['traffic']}.json"),
        limits=load_json(root / "benchmark" / "limits" / f"{cell_name}.json"),
        end_to_end=metrics_of(spec, cell_name, "end_to_end"),
        per_layer=metrics_of(spec, cell_name, "per_layer"),
    )


@dataclasses.dataclass
class Context:
    """What a job kind's set-up sees."""

    config: dict
    traffic: dict
    seed: int
    device: torch.device
    tmpdir: str
    rank: int = 0
    world: int = 1
    all_reduce: Callable = lambda t: t


@dataclasses.dataclass
class Window:
    """What a metric reader sees: the window's jobs, the program's counts
    over the window (`utils.profiling.COUNTS`, empty for a program
    without them) and, in a traced run, the summary of the trace."""

    cell: Cell
    setup_s: float
    window_s: float
    records: List[dict]
    trace: Optional[dict] = None
    world: int = 1
    counts: dict = dataclasses.field(default_factory=dict)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def dist_all_reduce(t: torch.Tensor) -> torch.Tensor:
    import torch.distributed as dist

    dist.all_reduce(t)
    return t


def _go_on(flag: bool, device: torch.device, world: int) -> bool:
    """Rank 0's decision, the same on every rank."""
    if world == 1:
        return flag
    import torch.distributed as dist

    dev = device if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    dist.broadcast(t, src=0)
    return bool(t.item())


def closed_loop(job, state, seconds: float, device, world: int, rank: int) -> tuple:
    """Jobs back to back until the first job end after `seconds`; returns
    (window seconds, records with each job's `wall_s`)."""
    records = []
    start = time.perf_counter()
    i = 0
    while True:
        t0 = time.perf_counter()
        with torch.profiler.record_function("bench.job"):
            rec = job.run(state, i)
            _sync(device)
        t1 = time.perf_counter()
        rec["wall_s"] = t1 - t0
        records.append(rec)
        i += 1
        if not _go_on(rank != 0 or t1 - start < seconds, device, world):
            return t1 - start, records


def read_metrics(defs: List[dict], win: Window) -> dict:
    out = {}
    for m in defs:
        mod = load_module(HERE / "metrics" / f"{m['name']}.py")
        val = mod.read(win)
        if val is not None:
            out[m["name"]] = {"value": float(val), "unit": m["unit"]}
    return out


def judge(limits: dict, readings: List[dict]) -> tuple:
    """(worst reading of each limited number, failed jobs)."""
    failed = sum(any(not r.get(k, FAR) <= lim for k, lim in limits.items())
                 for r in readings)
    worst = {k: min(max((r.get(k, FAR) for r in readings), default=FAR), FAR)
             for k in limits}
    return worst, failed


def program_counts():
    """The program's counter module (`utils.profiling`, with `COUNTS` and
    `reset_counts`), or None for a program without one."""
    try:
        from genomic_pca_tpu_torch.utils import profiling
    except ImportError:
        return None
    return profiling if hasattr(profiling, "COUNTS") else None


def run_cell(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool,
             device: str, tmpdir: str, t_start: float, rank: int = 0, world: int = 1,
             root: Path = ROOT) -> Optional[dict]:
    """One run of a cell; returns the result line's object on rank 0."""
    return run_cell_window(spec, cell_name, seed, seconds, trace, device, tmpdir,
                           t_start, rank, world, root)[0]


def run_cell_window(spec: dict, cell_name: str, seed: int, seconds: float, trace: bool,
                    device: str, tmpdir: str, t_start: float, rank: int = 0,
                    world: int = 1, root: Path = ROOT) -> tuple:
    """`run_cell`'s (result, the `Window` its readers read); (None, None)
    on ranks other than 0."""
    cell = load_cell(spec, cell_name, root)
    job = load_module(HERE / "jobs" / f"{cell.traffic['job']}.py")
    dev = torch.device(device)
    from genomic_pca_tpu_torch.ops import kernels
    from genomic_pca_tpu_torch.parallel import mesh

    ctx = Context(config=cell.config, traffic=cell.traffic, seed=seed, device=dev,
                  tmpdir=tmpdir, rank=rank, world=world,
                  all_reduce=dist_all_reduce if world > 1 else (lambda t: t))
    state = job.setup(ctx)
    job.run(state, -1)  # the warm-up job, of the cell's own shapes
    _sync(dev)
    setup_s = time.perf_counter() - t_start
    kernels.reset_launch_counts()
    mesh.reset_collective_counts()
    counter = program_counts()
    if counter is not None:
        counter.reset_counts()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    prof = tracemod.start(dev) if trace else None
    window_s, records = closed_loop(job, state, seconds, dev, world, rank)
    summary = tracemod.stop(prof, dev, world) if trace else None
    counts = dict(counter.COUNTS) if counter is not None else {}
    n_jobs = len(records)
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0
    launches = {k: v for k, v in kernels.LAUNCHES.items() if v}
    collectives = dict(mesh.COLLECTIVES)
    job.release(state)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    readings = job.check(state, records)
    if world > 1:
        peak = _max_over_ranks(peak, dev)
    if rank != 0:
        return None, None
    print(f"kernel launches per job: "
          f"{ {k: v / n_jobs for k, v in launches.items()} }", file=sys.stderr)
    print(f"collectives per job: { {k: v / n_jobs for k, v in collectives.items()} }",
          file=sys.stderr)
    print(f"max_memory_allocated: {peak}", file=sys.stderr)
    print(f"job walls (s): {[round(r['wall_s'], 4) for r in records]}", file=sys.stderr)
    if records and "qc_s" in records[0]:
        print(f"job qc_s: {[round(r['qc_s'], 3) for r in records]}", file=sys.stderr)
        print(f"job stages: {[r['stage_seconds'] for r in records]}", file=sys.stderr)
    print(f"worst readings: {compare.worst(readings)}", file=sys.stderr)
    win = Window(cell=cell, setup_s=setup_s, window_s=window_s, records=records,
                 trace=summary, world=world, counts=counts)
    metrics = read_metrics(cell.per_layer if trace else cell.end_to_end, win)
    worst, failed = judge(cell.limits, readings)
    result = {
        "correct": failed == 0 and bool(readings),
        "attempted": n_jobs,
        "failed": failed,
        "metrics": metrics,
        "device": device_info(dev, world, peak, summary),
    }
    if trace and summary is not None:
        result["breakdown"] = summary["breakdown"]
    result["checks"] = {k: {"value": worst[k], "limit": lim}
                        for k, lim in cell.limits.items()}
    return result, win


def _max_over_ranks(x: int, dev: torch.device) -> int:
    import torch.distributed as dist

    comm = dev if dist.get_backend() == "nccl" else torch.device("cpu")
    t = torch.tensor([x], dtype=torch.int64, device=comm)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return int(t.item())


def device_info(dev: torch.device, world: int, peak: int, summary) -> dict:
    if dev.type == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
                "count": world, "memory_peak_bytes": int(peak)}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": world,
                "memory_peak_bytes": 0}
    if summary is not None:
        info["busy_s"] = summary["busy_s"]
        info["window_s"] = summary["window_s"]
    return info


def per_job(win: Window, key: Callable[[dict], float]) -> Optional[float]:
    """The mean over the window's jobs of one reading of each job; None
    where no job has it."""
    vals = []
    for r in win.records:
        try:
            vals.append(float(key(r)))
        except (KeyError, TypeError):
            return None
    return float(np.mean(vals)) if vals else None


def count_per_job(win: Window, key: str) -> Optional[float]:
    """The program's count `key` over the window, a job; None where the
    program does not count it."""
    if key not in win.counts or not win.records:
        return None
    return win.counts[key] / len(win.records)


def mean_job_s(win: Window) -> Optional[float]:
    """The window's seconds over the jobs it completed."""
    return win.window_s / len(win.records) if win.records else None


def core_ms(win: Window) -> Optional[float]:
    """Device milliseconds a job in the traced window; None untraced or
    where the trace holds no device time."""
    t = win.trace
    if t is None or t["device_s"] <= 0 or not win.records:
        return None
    return 1e3 * t["device_s"] / len(win.records)


def idle_percent(win: Window) -> Optional[float]:
    t = win.trace
    if t is None or t["window_s"] <= 0 or t["n_device_events"] == 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

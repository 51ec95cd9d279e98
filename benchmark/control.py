"""Readings that set the limits of `correct`: the program's over many seeds
and the control's, at the cell's own size, in one process.

    python3 -m benchmark.control --workload <cell> --seeds 11 12 13 \
        [--jobs 3] [--controls 3] [--out FILE]

For each seed: the cell's set-up, a warm-up job and `--jobs` jobs of the
timed path (a short window at the cell's own load), the program's state
freed, and the reference's readings of each job; for the first
`--controls` seeds also the control's readings: the reference put in the
program's place with every operand of its products rounded to
CONTROL_DTYPE, fp8 e4m3, the precision below the configuration's bf16
operands.
One JSON line a seed on standard output (and appended to `--out`):
the worst reading of each number over the jobs, for the program and the
control.  Cells of one chip only.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
CONTROL_DTYPE = torch.float8_e4m3fn


def readings_for_seed(spec, cell, job, seed: int, n_jobs: int, with_control: bool,
                      device, tmpdir: str, rank: int = 0, world: int = 1) -> dict:
    from benchmark import harness
    from benchmark.reference import compare

    ctx = harness.Context(config=cell.config, traffic=cell.traffic, seed=seed,
                          device=torch.device(device), tmpdir=tmpdir, rank=rank,
                          world=world, all_reduce=harness.dist_all_reduce
                          if world > 1 else (lambda t: t))
    t0 = time.perf_counter()
    state = job.setup(ctx)
    job.run(state, -1)
    harness._sync(ctx.device)
    t1 = time.perf_counter()
    records = []
    for i in range(n_jobs):
        records.append(job.run(state, i))
    harness._sync(ctx.device)
    t2 = time.perf_counter()
    job.release(state)
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "setup_s": t1 - t0, "job_s": (t2 - t1) / max(n_jobs, 1),
           "program": compare.worst(job.check(state, records))}
    if with_control:
        t3 = time.perf_counter()
        ctl = job.control(state, seed, CONTROL_DTYPE)
        out["control"] = compare.worst(job.check(state, [ctl]))
        out["control_s"] = time.perf_counter() - t3
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--jobs", type=int, default=3)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--out")
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from benchmark import harness, run

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(spec, args.workload)
    job = harness.load_module(harness.HERE / "jobs" / f"{cell.traffic['job']}.py")
    world, procs = cell.chips, []
    if world > 1:
        if args.rank == 0:
            args.port = run.free_port()
            rest = list(argv if argv is not None else sys.argv[1:])
            procs = run.start_ranks("benchmark.control", rest, world, args.port)
        run.join_group(args.rank, world, args.port)
    for i, seed in enumerate(args.seeds):
        with tempfile.TemporaryDirectory(prefix="bench-") as tmp:
            line = readings_for_seed(spec, cell, job, seed, args.jobs,
                                     i < args.controls, "cuda", tmp, args.rank,
                                     world)
        if args.rank:
            continue
        line["workload"] = args.workload
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as fh:
                fh.write(text + "\n")
    if world > 1:
        from genomic_pca_tpu_torch.parallel import mesh

        mesh.shutdown()
    for p in procs:
        p.wait()
    return max([p.returncode for p in procs], default=0)


if __name__ == "__main__":
    sys.exit(main())

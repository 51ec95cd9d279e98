"""The benchmark's one command.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of `BENCHMARK.json` on the machine it is started on and
prints one JSON object as the last line of standard output; the numbers
that decide `correct`, each beside its limit, are the last lines of
standard error.  A cell of several chips starts its other ranks itself,
one process a GPU, joined through the program's `parallel/mesh.py` on a
port chosen at run time; rank 0 prints.  Exits 2, printing no result,
without CUDA or with fewer GPUs than the cell asks for, and 3 when JAX
or the JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import socket  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# Top-level module names that must not be loaded where the result is
# printed, compared whole (the port's name begins with the JAX package's).
FORBIDDEN = ("jax", "jaxlib", "flax", "genomic_pca_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--port", type=int, default=0, help=argparse.SUPPRESS)
    return ap.parse_args(argv)


def cache_env() -> None:
    """Build and kernel caches inside the checkout, at fixed paths."""
    os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton")
    os.environ["TORCHINDUCTOR_CACHE_DIR"] = str(ROOT / "build" / "torchinductor")
    os.environ["USE_FLAX"] = "0"


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def start_ranks(module: str, argv: list, world: int, port: int) -> list:
    """Ranks 1 .. world - 1 of `python -m module argv`, their standard
    output discarded (rank 0 prints)."""
    return [subprocess.Popen([sys.executable, "-m", module, *argv, "--rank", str(r),
                              "--port", str(port)], cwd=ROOT, stdout=subprocess.DEVNULL)
            for r in range(1, world)]


def join_group(rank: int, world: int, port: int) -> None:
    """This rank's place in the process group: one rank a GPU, NCCL."""
    from genomic_pca_tpu_torch.parallel import mesh

    os.environ["LOCAL_RANK"] = str(rank)
    os.environ["LOCAL_WORLD_SIZE"] = str(world)
    mesh.initialize_distributed("cuda", f"tcp://localhost:{port}", rank=rank,
                                world_size=world, timeout_s=300)


def main(argv=None) -> int:
    args = parse_args(argv)
    cache_env()
    import torch

    from benchmark import harness

    spec = harness.load_json(ROOT / "BENCHMARK.json")
    cell = harness.load_cell(spec, args.workload)
    world = cell.chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < world:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: {args.workload} needs {world} CUDA device(s), "
              f"found {n}", file=sys.stderr)
        return 2
    procs = []
    if world > 1:
        from genomic_pca_tpu_torch.parallel import mesh

        if args.rank == 0:
            args.port = free_port()
            procs = start_ranks("benchmark.run", [
                "--workload", args.workload, "--seed", str(args.seed), "--seconds",
                str(args.seconds), "--trace", str(args.trace)], world, args.port)
        join_group(args.rank, world, args.port)
    tmpdir = tempfile.mkdtemp(prefix="bench-")
    try:
        result = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                                  bool(args.trace), "cuda", tmpdir, T_START,
                                  rank=args.rank, world=world)
    except BaseException:
        for p in procs:  # ranks left waiting in a collective
            p.kill()
        raise
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)
        if world > 1:
            mesh.shutdown()
        for p in procs:
            p.wait()
    if args.rank != 0:
        return 0
    bad = [p.returncode for p in procs if p.returncode != 0]
    if bad:
        print(f"benchmark: ranks exited with {bad}", file=sys.stderr)
        return 1
    found = forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

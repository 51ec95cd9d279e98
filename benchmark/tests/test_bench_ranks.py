"""A cell's path over several ranks on the CPU, as a cell of four chips
runs it: two ranks over gloo, each making and holding its own rows,
rank 0 deciding when the window closes and printing; a run with the
exchange between ranks left out is not correct."""

import multiprocessing as mp
import socket
import tempfile
from pathlib import Path

import pytest

from benchmark.tests import tiny

CELL = "kgp3_chr22-rfit"
WORLD = 2


def _port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank(rank, port, root, fault, queue):
    import os
    import sys

    sys.path.insert(0, str(Path(__file__).resolve().parents[2]))
    os.environ["LOCAL_RANK"] = str(rank)
    import torch

    from benchmark import generate, harness
    from genomic_pca_tpu_torch.parallel import mesh

    torch.set_num_threads(2)

    # Strips of a few rows, so that both ranks hold rows of the tiny cell.
    generate.STRIP_ELEMS = 1 << 16

    if fault == "no_exchange":
        mesh.all_reduce_sum = lambda t: t
    mesh.initialize_distributed("cpu", f"tcp://localhost:{port}", rank=rank,
                                world_size=WORLD, timeout_s=120)
    try:
        with tempfile.TemporaryDirectory() as tmp:
            res = harness.run_cell(tiny.spec_of(Path(root)), CELL, 2**31 + 9, 0.5,
                                   False, "cpu", tmp, 0.0, rank=rank, world=WORLD,
                                   root=Path(root))
        queue.put((rank, res))
    finally:
        mesh.shutdown()


def run_ranks(root, fault=None):
    ctx = mp.get_context("spawn")
    queue = ctx.Queue()
    port = _port()
    procs = [ctx.Process(target=_rank, args=(r, port, str(root), fault, queue))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    got = dict(queue.get(timeout=600) for _ in range(WORLD))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    assert got[1] is None
    return got[0]


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.tiny_root(tmp_path_factory.mktemp("ranks"))


def test_two_ranks_sound(root):
    res = run_ranks(root)
    assert res["correct"], res["checks"]
    assert res["device"]["count"] == WORLD
    assert set(res["metrics"]) == {"setup_s", "pca_job_s", "pca_job_p90_s"}


def test_two_ranks_without_the_exchange(root):
    res = run_ranks(root, "no_exchange")
    assert not res["correct"], res["checks"]

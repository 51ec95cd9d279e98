"""On the card: the tiny cells through the program's CUDA kernels come
out correct, and the control at the tiny size reads above the limits.
Skips without a CUDA device (decided inside each test)."""

import tempfile

import pytest
import torch

from benchmark import control, harness
from benchmark.tests import tiny


@pytest.fixture
def root(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return tiny.tiny_root(tmp_path)


@pytest.mark.cuda
@pytest.mark.parametrize("cell", tiny.one_chip())
def test_tiny_cell_on_the_card(root, cell):
    with tempfile.TemporaryDirectory() as tmp:
        res = harness.run_cell(tiny.spec_of(root), cell, 2**31 + 3, 0.5, True, "cuda",
                               tmp, 0.0, root=root)
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    assert "device_idle.pca" in res["metrics"] or "device_idle.workflow" in res["metrics"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", ["kgp3_chr22-rfit"])
def test_control_fails_the_tiny_limits(root, cell):
    spec = tiny.spec_of(root)
    c = harness.load_cell(spec, cell, root)
    job = harness.load_module(harness.HERE / "jobs" / f"{c.traffic['job']}.py")
    with tempfile.TemporaryDirectory() as tmp:
        got = control.readings_for_seed(spec, c, job, 11, 1, True, "cuda", tmp)
    assert any(got["control"][k] > lim for k, lim in c.limits.items()), got
    assert all(got["program"][k] <= lim for k, lim in c.limits.items()), got

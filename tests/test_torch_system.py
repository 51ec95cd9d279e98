"""The port's `--profile-dir` trace and resource preflights on the CPU:
`utils/profiling.py` `maybe_trace` and `utils/system.py` against the JAX
package's `utils/system.py` on the same arguments."""

import json
import logging

import pytest
import torch

from genomic_pca_tpu.utils import system as jsys
from genomic_pca_tpu_torch.utils import system as tsys
from genomic_pca_tpu_torch.utils.profiling import maybe_trace


def test_maybe_trace_without_a_directory_does_nothing(tmp_path, monkeypatch):
    """No directory: no profiler is made and nothing is written."""
    import torch.profiler

    def refuse(*_a, **_k):
        raise AssertionError("a profiler was made")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    for empty in (None, ""):
        with maybe_trace(empty, "cpu"):
            x = torch.ones(3) * 2
    assert float(x.sum()) == 6.0
    assert not list(tmp_path.iterdir())


def test_maybe_trace_needs_a_device(tmp_path):
    """The device is a required argument: a caller that leaves it out
    fails at once instead of tracing no CUDA activity."""
    with pytest.raises(TypeError):
        with maybe_trace(str(tmp_path / "p")):
            pass
    assert not (tmp_path / "p").exists()


def test_maybe_trace_writes_a_chrome_trace(tmp_path, caplog):
    """Around CPU torch ops: one trace file for rank 0 that parses as JSON
    and holds the ops as CPU events."""
    out = tmp_path / "prof"
    with caplog.at_level(logging.INFO, logger="genomic_pca_tpu_torch"):
        with maybe_trace(str(out), "cpu"):
            a = torch.randn(64, 64)
            (a @ a).sum()
    assert [p.name for p in out.iterdir()] == ["trace.rank0.json"]
    trace = json.loads((out / "trace.rank0.json").read_text())
    names = {ev.get("name") for ev in trace["traceEvents"]}
    assert "aten::mm" in names
    assert "Profiler trace written to" in caplog.text


def test_maybe_trace_writes_nothing_after_an_error(tmp_path):
    with pytest.raises(ValueError):
        with maybe_trace(str(tmp_path / "p"), "cpu"):
            raise ValueError("workflow failed")
    assert not (tmp_path / "p" / "trace.rank0.json").exists()


@pytest.mark.parametrize("name", ["nofile", "nproc", "bogus"])
def test_rlimit_soft_matches_reference(name):
    assert tsys.rlimit_soft(name) == jsys.rlimit_soft(name)


@pytest.mark.parametrize("threads", [16, 1 << 20])
def test_preflight_logs_as_the_reference(caplog, threads):
    got = {}
    for mod, logger in ((tsys, "genomic_pca_tpu_torch"), (jsys, "genomic_pca_tpu")):
        with caplog.at_level(logging.INFO, logger=logger):
            caplog.clear()
            assert mod.preflight(planned_threads=threads) is None
            got[mod] = [(r.levelname, r.getMessage()) for r in caplog.records]
    assert got[tsys] == got[jsys]
    assert "Resource preflight: RLIMIT_NOFILE" in got[tsys][0][1]


def test_host_available_bytes_override(monkeypatch):
    monkeypatch.setenv("GENOMIC_PCA_HOST_BUDGET_BYTES", "12345")
    assert tsys.host_available_bytes() == jsys.host_available_bytes() == 12345
    monkeypatch.delenv("GENOMIC_PCA_HOST_BUDGET_BYTES")
    assert tsys.host_available_bytes() == jsys.host_available_bytes()


@pytest.mark.parametrize("per_pass,n_passes,resident", [
    (4 << 30, 1, True), (26 << 30, 5, False), (0, 0, False),
])
def test_memory_preflight_matches_reference(caplog, per_pass, n_passes, resident):
    """The estimate dict equals the JAX function's with `mirror=False`
    (less its `relay_mirror` key); the port logs and never raises."""
    kw = dict(per_pass_device_bytes=per_pass, n_passes=n_passes, resident=resident,
              device_budget_bytes=80 << 30, host_budget_bytes=96 << 30)
    with caplog.at_level(logging.INFO, logger="genomic_pca_tpu_torch"):
        got = tsys.memory_preflight(**kw)
    ref = jsys.memory_preflight(**kw, mirror=False)
    assert ref.pop("relay_mirror") is False
    assert got == ref
    assert "Memory preflight:" in caplog.text


class _Saved:
    """A checkpointer that holds the named stages."""

    enabled = True

    def __init__(self, stages):
        self.stages = set(stages)

    def has(self, stage):
        return stage in self.stages


@pytest.mark.parametrize("saved,stop,diagnostics", [
    ((), None, False), ((), "stage2_basis", False),
    (("stage1_bases", "stage2_basis"), None, False),
    (("stage1_bases", "stage2_basis"), None, True),
    (("stage2_basis", "refine_pass_0"), "refine_pass_1", False),
])
def test_planned_matrix_passes_match_reference(saved, stop, diagnostics):
    """The full-matrix passes the memory preflight counts, against the
    JAX `_planned_matrix_passes` for the same checkpoints and leg."""
    from genomic_pca_tpu.config import EigenSnpConfig as JConfig
    from genomic_pca_tpu.models.eigensnp import _planned_matrix_passes as jplan
    from genomic_pca_tpu_torch.config import EigenSnpConfig
    from genomic_pca_tpu_torch.models.eigensnp import _planned_matrix_passes

    got = _planned_matrix_passes(EigenSnpConfig(refine_passes=3), _Saved(saved),
                                 stop, diagnostics)
    assert got == jplan(JConfig(refine_passes=3), _Saved(saved), stop, diagnostics)

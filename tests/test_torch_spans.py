"""The port's spans and device-to-host counter (utils/profiling.py): the
`gp.` ranges a profiler sees in the randomized PCA, the data preparation
and the EigenSNP stages, the stage seconds taken from the same stamps,
and no `record_function` while no profiler runs.

The file imports no jax; its one test marked `cuda` runs on the card:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_spans.py
"""

from collections import Counter

import numpy as np
import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
from genomic_pca_tpu_torch.io.bed import write_plink
from genomic_pca_tpu_torch.models import eigensnp, prepare
from genomic_pca_tpu_torch.models.pca import streamed_pca
from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, pack_int8_rows
from genomic_pca_tpu_torch.utils import profiling
from genomic_pca_tpu_torch.utils.timing import StageTimer
from tests.torch_cases import balding_nichols, exact_pcs

PASSES = {"gp.pass.q8_pass": 3, "gp.pass.exact_pass": 1, "gp.pass.rr_gram": 1,
          "gp.pass.loadings": 1}


def _matrix(device="cpu", d=512, n=96, seed=3):
    g = balding_nichols(np.random.default_rng(seed), d, n, missing_rate=0.01)
    _, _, mean, std = exact_pcs(g, 1)
    return ShardedMatrix.from_packed_rows(pack_int8_rows(g), mean.astype(np.float32),
                                          std.astype(np.float32), n, device,
                                          tile_d=128)


def _fileset(tmp_path, d=600, n=80, n_blocks=4):
    g = balding_nichols(np.random.default_rng(5), d, n, missing_rate=0.01)
    prefix = str(tmp_path / "toy")
    write_plink(prefix, g, bp=list(np.arange(1, d + 1) * 10))
    edges = np.linspace(0, d * 10 + 10, n_blocks + 1, dtype=int)
    blocks = tmp_path / "blocks.tsv"
    blocks.write_text("".join(f"1 {edges[i] + 1} {edges[i + 1]}\n"
                              for i in range(n_blocks)))
    return DataPrepConfig(bed_path=prefix, ld_block_path=str(blocks),
                          min_call_rate=0.5, min_maf=0.01, max_hwe_p=1e-6,
                          snp_chunk_size=200)


def _gp_ranges(prof):
    """[(name, start us, end us)] of the trace's host-side `gp.` ranges."""
    return [(e.name, e.time_range.start, e.time_range.end) for e in prof.events()
            if e.device_type == DeviceType.CPU and e.name.startswith("gp.")]


def _inside(inner, outer):
    return any(o[1] <= inner[1] and inner[2] <= o[2] for o in outer)


# A span's stamps are taken inside its profiler range, so its seconds are
# at most the range's length; the profiler's clock may differ from
# perf_counter by this much.
CLOCKS = 1e-4


class Ticks:
    """A clock that moves one second at each reading: a span's seconds
    are then 1 + 2 x the spans inside it, whatever the host's load."""

    def __init__(self) -> None:
        self.now = 0.0

    def perf_counter(self) -> float:
        self.now += 1.0
        return self.now


def test_streamed_pca_span_tree():
    """n_power_iter 4 with one exact polish pass: three q8 passes, the
    exact pass, the Rayleigh-Ritz Gram and the loadings, each once a
    pass, every range inside the one `gp.pca`."""
    sm = _matrix()
    assert sm.q8_polish == 1
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        streamed_pca(sm, k=4, n_power_iter=4, seed=7)
    ranges = _gp_ranges(prof)
    got = Counter(name for name, _, _ in ranges)
    assert {k: got[k] for k in PASSES} == PASSES
    assert got["gp.pca"] == 1 and got["gp.pca.sketch"] == 1
    # CholQR2 after each of the four passes, the Householder QR, eigh.
    assert got["gp.pca.orth"] == 6
    # The loadings' gather in pca_core, then the scores and eigenvalues.
    assert got["gp.pca.to_host"] == 2
    outer = [r for r in ranges if r[0] == "gp.pca"]
    assert all(_inside(r, outer) for r in ranges if r[0] != "gp.pca")


def test_prepare_spans_nest_and_make_stage_seconds(tmp_path):
    """`gp.prepare.open`, `.qc_scan` and the two `.ld_map` ranges inside
    `gp.prepare`; `stage_seconds` holds their durations."""
    cfg = _fileset(tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prep = prepare.prepare_data(cfg, device="cpu")
    ranges = _gp_ranges(prof)
    got = Counter(name for name, _, _ in ranges)
    assert got == Counter({"gp.prepare": 1, "gp.prepare.open": 1,
                           "gp.prepare.qc_scan": 1, "gp.prepare.ld_map": 2})
    outer = [r for r in ranges if r[0] == "gp.prepare"]
    assert all(_inside(r, outer) for r in ranges)
    assert set(prep.stage_seconds) == {"open", "qc_scan", "ld_map"}
    for key, name in (("open", "gp.prepare.open"), ("qc_scan", "gp.prepare.qc_scan"),
                      ("ld_map", "gp.prepare.ld_map")):
        span_s = sum(t - s for n, s, t in ranges if n == name) / 1e6
        assert 0.0 < prep.stage_seconds[key] <= span_s + CLOCKS, key


STAGE_SPANS = {"open": "gp.prepare.open", "qc_scan": "gp.prepare.qc_scan",
               "ld_map": "gp.prepare.ld_map", "matrix_load": "gp.eigensnp.load",
               "stages_1_2": "gp.eigensnp.stages12", "global_pca": "gp.eigensnp.global",
               "refinement_finalize": "gp.eigensnp.refine"}


def _eigensnp_job(tmp_path):
    """An EigenSNP job on the CPU under the profiler: (result, ranges)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        prep = prepare.prepare_data(_fileset(tmp_path), device="cpu")
        res = eigensnp.compute_eigensnp_pca(
            prep, EigenSnpConfig(k_global=3, min_subset_size=40, seed=9), device="cpu")
    return res, _gp_ranges(prof)


def test_stage_seconds_are_their_spans_stamps(tmp_path, monkeypatch):
    """Every `stage_seconds` value of an EigenSNP job (the preparation's
    and the four stages') is the seconds of its spans' own stamps: on a
    clock that ticks once a reading, one tick and two for each span
    inside; on the host's clock, inside the span's profiler range."""
    res, ranges = _eigensnp_job(tmp_path)
    assert Counter(n for n, _, _ in ranges if n.startswith("gp.eigensnp")) == Counter(
        list(STAGE_SPANS.values())[3:])
    for key, name in STAGE_SPANS.items():
        span_s = sum(t - s for n, s, t in ranges if n == name) / 1e6
        # stage_seconds are rounded to 1 ms
        assert 0.0 <= res.stage_seconds[key] <= span_s + 5e-4 + CLOCKS, key
    # The refinement's pca_core passes lie inside its stage.
    refine = [r for r in ranges if r[0] == "gp.eigensnp.refine"]
    assert all(_inside(r, refine) for r in ranges if r[0].startswith("gp.pass."))

    monkeypatch.setattr(profiling, "time", Ticks())
    res, ranges = _eigensnp_job(tmp_path)
    for key, name in STAGE_SPANS.items():
        own = [r for r in ranges if r[0] == name]
        inner = [r for r in ranges if r not in own and _inside(r, own)]
        assert res.stage_seconds[key] == len(own) + 2 * len(inner), key


def test_no_profiler_no_record_function(tmp_path, monkeypatch):
    """Without a profiler a span never enters `record_function`: with it
    made to raise, the PCA, the preparation and the EigenSNP job run."""
    def refuse(*_a, **_k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    res = streamed_pca(_matrix(), k=4, n_power_iter=4, seed=7)
    assert res.scores.shape == (96, 4)
    prep = prepare.prepare_data(_fileset(tmp_path), device="cpu")
    got = eigensnp.compute_eigensnp_pca(
        prep, EigenSnpConfig(k_global=3, min_subset_size=40, seed=9), device="cpu")
    assert got.scores.shape == (80, 3)
    with profiling.span("gp.test") as s:
        pass
    assert s.seconds >= 0.0


def test_stage_timer_stages_are_spans():
    """A workflow stage is a `gp.workflow.<stage>` range, and the timer
    keeps the span's seconds."""
    timer = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.stage("Output writing"):
            torch.ones(8).sum()
    ranges = [r for r in _gp_ranges(prof) if r[0] == "gp.workflow.Output writing"]
    assert len(ranges) == 1
    assert 0.0 < timer.stages["Output writing"] <= (ranges[0][2] - ranges[0][1]) / 1e6 + CLOCKS


def test_to_host_counts_only_card_tensors():
    profiling.reset_counts()
    out = profiling.to_host(torch.arange(6, dtype=torch.float32))
    assert out.device.type == "cpu" and out.tolist() == [0, 1, 2, 3, 4, 5]
    assert profiling.COUNTS == {"d2h_bytes": 0}


@pytest.mark.cuda
def test_d2h_bytes_counts_loadings_and_scores_exactly():
    """On the card one rfit job brings back the loadings (d_pad x k f32),
    the scores (n x k f32), sigma and the eigenvalues (k f32 each), and
    nothing else."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    sm = _matrix("cuda", d=4096, n=300)
    k = 5
    streamed_pca(sm, k=k, n_power_iter=4, seed=7)  # warm-up
    profiling.reset_counts()
    streamed_pca(sm, k=k, n_power_iter=4, seed=8)
    assert profiling.COUNTS["d2h_bytes"] == 4 * k * (sm.d_pad + 300 + 2)

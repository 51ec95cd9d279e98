"""The port's host-streamed container against the JAX package's, on the CPU.

`ops/streaming.py` `StreamingMatrix` against the JAX `StreamingMatrix`
(mode "pallas_interpret" / "pallas2d_interpret") on the same host strips,
packed and dense, in both modes; `streamed_pca` on a streamed container
against the resident one; the streaming switch of `load_matrix`
(`will_stream`); the host block accessors; and `compute_eigensnp_pca`
with `force_streaming=True` and with nested LD blocks (the host-accessor
stages 1-2) against the JAX run.  Workflow checks hold per-PC |r| >
0.999 over the eigengap-separated prefix.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.config import EigenSnpConfig
from genomic_pca_tpu.models import eigensnp as jes
from genomic_pca_tpu.models import pca as jpca
from genomic_pca_tpu.models import prepare as jprep
from genomic_pca_tpu.ops.streaming import StreamingMatrix as JStreamingMatrix
from genomic_pca_tpu_torch.models import eigensnp as tes
from genomic_pca_tpu_torch.models import pca as tpca
from genomic_pca_tpu_torch.models import prepare as tprep
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix
from genomic_pca_tpu_torch.parallel import sharded as ts
from tests.conftest import make_genotypes
from tests.test_eigensnp import _setup
from tests.torch_cases import abs_corr, exact_pcs

CASES = [(packed, mode) for packed in (True, False) for mode in ("1d", "2d")]
JAX_MODE = {"1d": "pallas_interpret", "2d": "pallas2d_interpret"}
# The kernels' bf16 bars (tests/test_torch_dense.py BF16_TOL).
BF16_TOL = {"gram_apply": (1e-2, 1e-3), "right_apply": (1e-2, 1e-3),
            "tsq_accumulate": (1e-2, 2e-2)}


def _separated(evals, k):
    return next((j for j in range(k) if (evals[j] - evals[j + 1]) / evals[j] < 0.05), k)


def _source(g, strip, packed):
    """Strip i of (D, N) int8 dosages as a streaming source gives it: rows
    padded to `strip` with inert rows (missing, std 0)."""
    mean, std = ts.host_moments(g)

    def source(i):
        lo, hi = i * strip, min((i + 1) * strip, g.shape[0])
        pad = strip - (hi - lo)
        gs = np.pad(g[lo:hi], ((0, pad), (0, 0)), constant_values=-127)
        ms, ss = np.pad(mean[lo:hi], (0, pad)), np.pad(std[lo:hi], (0, pad))
        return (ts.pack_int8_rows(gs) if packed else gs), ms, ss

    return source, -(-g.shape[0] // strip)


def _pair(g, packed, mode, precision, strip=128, tile_d=128):
    d, n = g.shape
    source, n_strips = _source(g, strip, packed)
    sm_j = JStreamingMatrix(source, n_strips=n_strips, n_rows=d, n_samples=n,
                            strip_size=strip, mode=JAX_MODE[mode], packed=packed,
                            kernel_precision=precision, tile_d=tile_d)
    sm_t = StreamingMatrix(source, n_strips=n_strips, n_rows=d, n_samples=n,
                           strip_size=strip, mode=mode, packed=packed,
                           kernel_precision=precision, tile_d=tile_d, device="cpu")
    return sm_j, sm_t


@pytest.mark.parametrize("packed,mode", CASES)
@pytest.mark.parametrize("name", ["gram_apply", "tsq_accumulate", "right_apply"])
def test_streaming_passes_match_reference(rng, packed, mode, name):
    """bf16 exact passes over 3 strips (a ragged last one) of 5%-missing
    genotypes; the 2-D modes hold two or more JAX sample tiles."""
    g = make_genotypes(rng, 300, 1000, missing_rate=0.05)
    sm_j, sm_t = _pair(g, packed, mode, "bf16")
    assert sm_t.mode == mode and sm_t.packed == packed and sm_t.n_strips == 3
    b = np.random.default_rng(4).standard_normal((1000, 9)).astype(np.float32)
    b /= np.sqrt(1000)
    ref = np.asarray(getattr(sm_j, name)(jnp.asarray(b)))
    tk.reset_launch_counts()
    got = getattr(sm_t, name)(torch.from_numpy(b))
    got = got if isinstance(got, np.ndarray) else got.numpy()
    assert all(v == 0 for v in tk.LAUNCHES.values())  # CPU: plain versions
    np.testing.assert_allclose(got, ref, *BF16_TOL[name])
    tel = sm_t.last_telemetry
    assert tel["strips"] == 3 and tel["copy_seconds"] is None
    row_bytes = sm_t.n_cols + 8  # genotypes + mean + inv_std
    assert tel["bytes"] == 3 * 128 * row_bytes


@pytest.mark.parametrize("packed,mode", CASES)
def test_streaming_q8_pca_matches_reference(packed, mode):
    """q8 steering then the exact polish, then the fused Gram and loadings:
    per-PC |r| > 0.999 against the JAX streaming run and the float64
    oracle over the separated prefix, eigenvalues within 5e-3 (the
    reference's q8 bar, tests/test_q8.py:112-114)."""
    g = make_genotypes(np.random.default_rng(0), 1024, 192, missing_rate=0.02,
                       n_pops=5, fst=0.2)
    sm_j, sm_t = _pair(g, packed, mode, "q8", strip=256)
    v_true, evals, _, _ = exact_pcs(g, 5)
    sep = _separated(evals, 4)
    assert sep >= 3
    res_j = jpca.streamed_pca(sm_j, k=4, n_power_iter=5, seed=3,
                              compute_loadings=True)
    res_t = tpca.streamed_pca(sm_t, k=4, n_power_iter=5, seed=3,
                              compute_loadings=True)
    assert res_t.loadings.shape == (1024, 4)
    assert [p["pass"] for p in sm_t.pass_log] == ["q8"] * 4 + ["gram", "tsq_capture"]
    np.testing.assert_allclose(res_t.eigenvalues[:sep], res_j.eigenvalues[:sep],
                               rtol=5e-3)
    for j in range(sep):
        assert abs_corr(res_t.scores[:, j], res_j.scores[:, j]) > 0.999, j
        assert abs_corr(res_t.scores[:, j], v_true[:, j]) > 0.999, j
        assert abs_corr(res_t.loadings[:, j], res_j.loadings[:, j]) > 0.999, j


@pytest.mark.parametrize("packed", [True, False])
def test_streamed_pca_on_streamed_matches_resident(packed):
    """The same genotypes streamed in strips of 100 rows and resident:
    the same PCs (per-PC |r| > 0.999 over the separated prefix) and the
    same eigenvalues (q8 bar)."""
    g = make_genotypes(np.random.default_rng(0), 1024, 192, missing_rate=0.02,
                       n_pops=5, fst=0.2)
    mean, std = ts.host_moments(g)
    source, n_strips = _source(g, 100, packed)
    sm_s = StreamingMatrix(source, n_strips, 1024, 192, 100, packed=packed,
                           device="cpu")
    sm_r = (ts.ShardedMatrix.from_packed_rows(ts.pack_int8_rows(g), mean, std, 192,
                                              "cpu") if packed else
            ts.ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                         device="cpu"))
    assert sm_s.mode == sm_r.mode == "1d" and sm_s.n_pad == sm_r.n_pad
    res_s = tpca.streamed_pca(sm_s, k=4, seed=5, compute_loadings=True)
    res_r = tpca.streamed_pca(sm_r, k=4, seed=5, compute_loadings=True)
    _, evals, _, _ = exact_pcs(g, 5)
    for j in range(_separated(evals, 4)):
        assert abs_corr(res_s.scores[:, j], res_r.scores[:, j]) > 0.999, j
        assert abs_corr(res_s.loadings[:, j], res_r.loadings[:, j]) > 0.999, j
    np.testing.assert_allclose(res_s.eigenvalues, res_r.eigenvalues, rtol=5e-3)


def test_tsq_and_project_matches_capture_and_tsq(rng):
    """The device-side capture gives the host capture's loadings and the
    tsq pass's Gram; past its budget it declines."""
    g = make_genotypes(rng, 250, 90, missing_rate=0.02)
    source, n_strips = _source(g, 64, True)
    sm = StreamingMatrix(source, n_strips, 250, 90, 64, packed=True,
                         kernel_precision="f32", device="cpu")
    b = torch.from_numpy(rng.standard_normal((90, 6)).astype(np.float32))
    w = rng.standard_normal((6, 3)).astype(np.float32)
    g_p, project = sm.tsq_and_project(b)
    g_c, ab = sm._tsq_and_capture(b)
    np.testing.assert_allclose(g_p.numpy(), g_c.numpy(), rtol=1e-6)
    np.testing.assert_allclose(g_p.numpy(), sm.tsq_accumulate(b).numpy(), rtol=1e-6)
    np.testing.assert_allclose(project(w), ab @ w, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ab, sm.right_apply(b), rtol=1e-6)
    assert ab.shape == (250, 6)
    sm._CAPTURE_DEVICE_BUDGET = 100
    assert sm.tsq_and_project(b) is None


def test_will_stream_at_a_patched_budget(tmp_path, rng, monkeypatch):
    """The 60% rule of the reference, on the resident estimate; the
    streamed container then holds the PCA rows and moments."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=300, n_samples=40)
    prep = tprep.prepare_data(cfg)
    need = prep.estimate_resident_bytes()
    assert need == prep.n_pca_snps * 128 == prep.estimate_streamed_pass_bytes()
    assert need == jprep.prepare_data(cfg).estimate_resident_bytes()
    for budget, want in ((int(need / 0.6) + 1, False), (int(need / 0.6) - 1, True)):
        monkeypatch.setattr(tprep, "device_memory_budget", lambda device, b=budget: b)
        assert prep.will_stream(device="cpu") is want
        assert prep.will_stream(force_streaming=True, device="cpu") is True
        sm = prep.load_matrix("cpu", strip_size=100)
        assert isinstance(sm, StreamingMatrix) is want
    b = torch.from_numpy(rng.standard_normal((40, 4)).astype(np.float32))
    resident = tprep.PreparedData.load_matrix
    monkeypatch.setattr(tprep, "device_memory_budget", lambda device: 1 << 40)
    np.testing.assert_allclose(sm.right_apply(b), resident(prep, "cpu").right_apply(b),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("keep_list", [False, True])
def test_host_block_accessors_match_reference(tmp_path, rng, keep_list):
    _, _, cfg = _setup(tmp_path, rng, n_snps=300, n_samples=37, missing_rate=0.05)
    if keep_list:
        keep = tmp_path / "keep.txt"
        keep.write_text("".join(f"sample{i}\n" for i in range(0, 37, 2)))
        cfg = dataclasses.replace(cfg, sample_keep_path=str(keep))
    pt, pj = tprep.prepare_data(cfg), jprep.prepare_data(cfg)
    assert pt.supports_packed_blocks == pj.supports_packed_blocks == (not keep_list)
    ids = np.array([3, 4, 5, 40, 41, 100])
    for kw in ({}, {"pad_rows_to": 8}, {"sample_subset": np.array([0, 5, 9])}):
        np.testing.assert_array_equal(pt.fetch_block_standardized(ids, **kw),
                                      np.asarray(pj.fetch_block_standardized(ids, **kw)))
    if not keep_list:
        for got, ref in zip(pt.fetch_block_packed(ids, pad_rows_to=8),
                            pj.fetch_block_packed(ids, pad_rows_to=8)):
            np.testing.assert_array_equal(got, ref)


# ---------------------------------------------------------------------------
# EigenSNP through the host-streamed container and the host accessor.


def _eigensnp_pair(cfg, algo, **kw_t):
    pt = tprep.prepare_data(cfg, device="cpu")
    res_t = tes.compute_eigensnp_pca(pt, algo, device="cpu", **kw_t)
    res_j = jes.compute_eigensnp_pca(jprep.prepare_data(cfg), algo,
                                     force_streaming=kw_t.get("force_streaming", False))
    raw = pt.bed.read(pt.pca_snp_orig_indices, pt.qc_sample_indices)
    _, evals, _, _ = exact_pcs(raw, algo.k_global + 1)
    sep = _separated(evals, algo.k_global)
    assert sep >= 2
    for j in range(sep):
        assert abs_corr(res_t.scores[:, j], res_j.scores[:, j]) > 0.999, j
        assert abs_corr(res_t.loadings[:, j], res_j.loadings[:, j]) > 0.999, j
    np.testing.assert_allclose(res_t.eigenvalues[:sep], res_j.eigenvalues[:sep],
                               rtol=5e-3)
    return res_t


@pytest.mark.parametrize("pipeline", ["packed", "dense", "keep_list"])
def test_eigensnp_force_streaming_matches_reference(tmp_path, pipeline):
    """`force_streaming=True`: the streamed container (packed strips,
    dense strips, or a keep-list's columns repacked), stages 1-2 through
    the host accessor, refinement by streamed passes and tsq_and_project,
    against the JAX package's streamed run."""
    # Seed 5: 4 PCs separated by 5% eigengaps.
    _, _, cfg = _setup(tmp_path, np.random.default_rng(5), n_snps=800,
                       n_samples=100, n_pops=5, fst=0.25)
    if pipeline == "dense":
        cfg = dataclasses.replace(cfg, packed_pipeline=False)
    if pipeline == "keep_list":
        keep = tmp_path / "keep.txt"
        keep.write_text("".join(f"sample{i}\n" for i in range(0, 100, 4)
                                if i % 3 != 1) + "sample1\n")
        cfg = dataclasses.replace(cfg, sample_keep_path=str(keep))
    algo = EigenSnpConfig(k_global=4, components_per_block=10, subset_factor=1.0,
                          min_subset_size=10, max_subset_size=100_000,
                          refine_passes=2, snp_strip_size=128)
    res = _eigensnp_pair(cfg, algo, force_streaming=True)
    assert res.container == "host-streamed"


def test_eigensnp_nested_blocks_run_through_the_host_accessor(tmp_path, rng):
    """A nested LD-block file (the inner block first leaves a hole in the
    outer one): its blocks are not contiguous runs, so stages 1-2 read
    them through the host accessor, with the resident container, on both
    sides; a 30-of-80 sample subset."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=600, n_samples=80, n_pops=5, fst=0.25)
    nested = tmp_path / "nested.tsv"
    nested.write_text("1 1001 2600\n1 1 3500\n1 3501 6010\n")
    cfg = dataclasses.replace(cfg, ld_block_path=str(nested))
    assert tes._blocks_as_runs(tprep.prepare_data(cfg).blocks) is None
    algo = EigenSnpConfig(k_global=4, components_per_block=8, subset_factor=0.375,
                          min_subset_size=10, max_subset_size=30, refine_passes=2,
                          collect_diagnostics=True)
    res = _eigensnp_pair(cfg, algo)
    assert res.container == "device-resident"
    assert res.diagnostics["matrix_path"] == "host-accessor"


def test_workflow_force_streaming_logs_the_container(tmp_path, caplog):
    """`run_eigensnp_workflow(force_streaming=True)` writes the files of
    the resident run with the same PCs, and logs the container that ran
    and the upload of each pass."""
    import logging

    from genomic_pca_tpu_torch.workflows import run_eigensnp_workflow

    _, _, cfg = _setup(tmp_path, np.random.default_rng(5), n_snps=800,
                       n_samples=100, n_pops=5, fst=0.25)
    algo = EigenSnpConfig(k_global=4, components_per_block=10, min_subset_size=100,
                          refine_passes=2, snp_strip_size=300)
    out = {}
    for streamed in (False, True):
        prefix = str(tmp_path / f"out{int(streamed)}")
        with caplog.at_level(logging.INFO, logger="genomic_pca_tpu_torch"):
            caplog.clear()
            run_eigensnp_workflow(cfg, algo, prefix, device="cpu",
                                  force_streaming=streamed)
        container = "host-streamed" if streamed else "device-resident"
        assert f"EigenSNP matrix container: {container}." in caplog.text
        assert "Kernel launches: " in caplog.text
        out[streamed] = np.loadtxt(f"{prefix}.eigensnp.pca.tsv", skiprows=1,
                                   usecols=range(1, 5), delimiter="\t")
    for j in range(4):
        assert abs_corr(out[True][:, j], out[False][:, j]) > 0.999, j

"""The port's EigenSNP workflow against the JAX package's, on the CPU.

BED fileset -> `prepare_data` (bit-identical QC, LD mapping and packed
matrix) -> `compute_eigensnp_pca` (per-PC |r| against the reference and
against the float64 oracle `models/exact.py`) -> `run_eigensnp_workflow`
(the reference's TSV formats), plus the batched rSVD, checkpoint legs and
diagnostics.  The port draws its subset and sketches from torch
generators, the reference from jax threefry, so PCs are compared by
sign-invariant |r|, never bit for bit.
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.config import DataPrepConfig, EigenSnpConfig
from genomic_pca_tpu_torch.errors import ComputeError, DataPrepError
from genomic_pca_tpu.models import eigensnp as jes
from genomic_pca_tpu.models import prepare as jprep
from genomic_pca_tpu.models.exact import exact_pca_from_strips
from genomic_pca_tpu.ops import hwe as jhwe
from genomic_pca_tpu.ops import qc as jqc
from genomic_pca_tpu.ops import rsvd as jrsvd
from genomic_pca_tpu.workflows import run_eigensnp_workflow as jax_run_eigensnp
from genomic_pca_tpu_torch.models import eigensnp as tes
from genomic_pca_tpu_torch.models import prepare as tprep
from genomic_pca_tpu_torch.ops import hwe as thwe
from genomic_pca_tpu_torch.ops import qc as tqc
from genomic_pca_tpu_torch.ops import rsvd as trsvd
from genomic_pca_tpu_torch.parallel import sharded as ts
from genomic_pca_tpu_torch.workflows import run_eigensnp_workflow
from tests.test_eigensnp import _setup
from tests.torch_cases import abs_corr

GOLDEN = Path(__file__).parent / "golden" / "eigensnp_diagnostics_schema.json"


def _exact(prep, cfg, k):
    raw = prep.bed.read(prep.pca_snp_orig_indices, prep.qc_sample_indices)
    return exact_pca_from_strips(iter([raw]), prep.n_samples, k=k, config=cfg,
                                 scale=True, apply_qc=False)


# PLINK filesets come from the reference's own fixture (`_setup`: structured
# genotypes, equal-interval LD blocks, min_call_rate 0.5, HWE 1e-6).


# ---------------------------------------------------------------------------
# ops/rsvd.py: the batched rSVD with the reference's own sketch.


@pytest.mark.parametrize("orth", ["qr", "cholqr2"])
def test_batched_rsvd_matches_reference_with_same_omega(rng, orth):
    """A batch of 3 through the port against the reference per matrix,
    each with the reference's own jax sketch (rtol 1e-4 on s; U and Vt
    after sign canonicalisation).  Block 2 has zero rows, as bucket
    padding gives: CholQR2 must stay finite."""
    k, n_os = 4, 6
    xs = rng.standard_normal((3, 60, 90)).astype(np.float32)
    xs[:, :, :5] *= 8.0  # a few strong directions
    xs[2, 40:] = 0.0
    keys = [jax.random.fold_in(jax.random.PRNGKey(7), i) for i in range(3)]
    omegas = np.stack([np.asarray(jax.random.normal(key, (90, k + n_os)))
                       for key in keys])
    u, s, vt = trsvd.rsvd(torch.from_numpy(xs), torch.from_numpy(omegas), k,
                          n_oversamples=n_os, n_power_iter=2, orth=orth)
    assert u.shape == (3, 60, k) and s.shape == (3, k) and vt.shape == (3, k, 90)
    for i in range(3):
        uj, sj, vtj = jrsvd.rsvd(jnp.asarray(xs[i]), keys[i], k=k,
                                 n_oversamples=n_os, n_power_iter=2, orth=orth)
        np.testing.assert_allclose(s[i].numpy(), np.asarray(sj), rtol=1e-4)
        ut, vtt = trsvd.sign_canonicalize(u[i], vt[i])
        ur, vtr = jrsvd.sign_canonicalize(uj, vtj)
        np.testing.assert_allclose(ut.numpy(), np.asarray(ur), atol=2e-4)
        np.testing.assert_allclose(vtt.numpy(), np.asarray(vtr), atol=2e-4)
    assert not u[2, 40:].any()


def test_batched_cholqr2_matches_reference_per_matrix(rng):
    t = rng.standard_normal((2, 200, 12)).astype(np.float32)
    t[1, :, 11] = 0.0
    q = trsvd.cholqr2_q(torch.from_numpy(t)).numpy()
    for i in range(2):
        np.testing.assert_allclose(q[i], np.asarray(jrsvd.cholqr2_q(jnp.asarray(t[i]))),
                                   rtol=1e-4, atol=1e-5)
    assert np.all(q[1, :, 11] == 0.0) and np.isfinite(q).all()


def test_exact_svd_and_rsvd_checks(rng):
    x = rng.standard_normal((30, 20)).astype(np.float32)
    u, s, vt = trsvd.exact_svd(torch.from_numpy(x), 5)
    uj, sj, vtj = jrsvd.exact_svd(jnp.asarray(x), 5)
    np.testing.assert_allclose(s.numpy(), np.asarray(sj), rtol=1e-5)
    ut, vtt = trsvd.sign_canonicalize(u, vt)
    ur, vtr = jrsvd.sign_canonicalize(uj, vtj)
    np.testing.assert_allclose(ut.numpy(), np.asarray(ur), atol=1e-4)
    np.testing.assert_allclose(vtt.numpy(), np.asarray(vtr), atol=1e-4)
    with pytest.raises(ValueError, match="omega"):
        trsvd.rsvd(torch.from_numpy(x), torch.zeros((20, 4)), 3)
    with pytest.raises(ValueError, match="orth"):
        trsvd.rsvd(torch.from_numpy(x), torch.zeros((20, 13)), 3, orth="svd")
    assert trsvd.sketch_width(3, 10, 30, 20) == 13


# ---------------------------------------------------------------------------
# Host QC and prepare_data: bit for bit.


def test_qc_helpers_bit_equal(rng):
    raw = rng.integers(0, 256, size=(40, 10), dtype=np.uint8)
    for n in (37, 40):
        np.testing.assert_array_equal(tqc.genotype_counts_packed_host(raw, n),
                                      jqc.genotype_counts_packed_host(raw, n))
    counts = tqc.genotype_counts_packed_host(raw, 37)
    cfg = DataPrepConfig(min_call_rate=0.5, min_maf=0.05, max_hwe_p=1e-3)
    got = tqc.snp_qc_from_counts(*counts.T, 37, cfg)
    ref = jqc.snp_qc_from_counts(*counts.T, 37, cfg)
    for a in ("keep", "mean", "std"):
        np.testing.assert_array_equal(getattr(got, a), getattr(ref, a))
    assert got.n_kept == ref.n_kept
    n = rng.integers(0, 50, size=(3, 200))
    n[:, :3] = 0
    np.testing.assert_array_equal(thwe.hwe_chi2_p(*n), jhwe.hwe_chi2_p(*n))


@pytest.mark.parametrize("keep_list", [False, True])
def test_prepare_data_bit_identical_to_reference(tmp_path, rng, keep_list):
    _, _, cfg = _setup(tmp_path, rng, n_snps=400, n_samples=50, missing_rate=0.05)
    if keep_list:
        keep = tmp_path / "keep.txt"
        keep.write_text("".join(f"sample{i}\n" for i in range(0, 50, 3)))
        cfg = dataclasses.replace(cfg, sample_keep_path=str(keep))
    pt, pj = tprep.prepare_data(cfg), jprep.prepare_data(cfg)
    np.testing.assert_array_equal(pt.qc_sample_indices, pj.qc_sample_indices)
    assert pt.sample_ids == pj.sample_ids
    np.testing.assert_array_equal(pt.pca_snp_orig_indices, pj.pca_snp_orig_indices)
    for a in ("mean", "std"):
        assert getattr(pt, a).dtype == getattr(pj, a).dtype
        np.testing.assert_array_equal(getattr(pt, a), getattr(pj, a))
    assert [b.tag for b in pt.blocks] == [b.tag for b in pj.blocks]
    for bt, bj in zip(pt.blocks, pj.blocks):
        np.testing.assert_array_equal(bt.pca_snp_ids, bj.pca_snp_ids)
    assert (pt.n_snps_pre_qc, pt.n_snps_post_qc) == (pj.n_snps_pre_qc, pj.n_snps_post_qc)
    assert pt.missing_fraction_bound == pj.missing_fraction_bound
    for a, b in zip(pt.snp_metadata(), pj.snp_metadata()):
        np.testing.assert_array_equal(a, b)
    # The resident packed matrix holds the reference's bytes and moments.
    sm_t, sm_j = pt.load_matrix("cpu"), pj.load_matrix()
    d = pt.n_pca_snps
    assert sm_t.n_rows == sm_j.n_rows == d
    np.testing.assert_array_equal(sm_t.geno.numpy(), np.asarray(sm_j.geno)[:d])
    np.testing.assert_array_equal(sm_t.inv_std.numpy(), np.asarray(sm_j.inv_std)[:d])
    np.testing.assert_array_equal(sm_t.mean.numpy(), np.asarray(sm_j.mean)[:d])
    assert pt.estimate_resident_bytes() == pj.estimate_resident_bytes()


def test_prepare_refuses_what_is_not_ported(tmp_path, rng, monkeypatch):
    """The device QC scan (it used to be refused) gives the host scan's
    keep, mean and std bit for bit; past 60% of the device's memory
    `load_matrix` takes the host-streamed container (it used to refuse
    it) over the same rows and moments."""
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix

    _, _, cfg = _setup(tmp_path, rng, n_snps=200, n_samples=30)
    dev = tprep.prepare_data(dataclasses.replace(cfg, qc_mode="device"), device="cpu")
    prep = tprep.prepare_data(cfg)
    np.testing.assert_array_equal(dev.pca_snp_orig_indices, prep.pca_snp_orig_indices)
    np.testing.assert_array_equal(dev.mean, prep.mean)
    np.testing.assert_array_equal(dev.std, prep.std)
    assert isinstance(prep.load_matrix("cpu"), ts.ShardedMatrix)
    monkeypatch.setattr(tprep, "device_memory_budget", lambda device: 1024)
    sm = prep.load_matrix("cpu", strip_size=64)
    assert isinstance(sm, StreamingMatrix) and sm.packed
    assert (sm.n_rows, sm.n_samples) == (prep.n_pca_snps, 30)


def test_missing_policy_error(tmp_path, rng):
    _, _, cfg = _setup(tmp_path, rng, n_snps=200, n_samples=30, missing_rate=0.05)
    cfg = dataclasses.replace(cfg, missing_policy="error")
    with pytest.raises(DataPrepError, match="missing_policy"):
        tprep.prepare_data(cfg).load_matrix("cpu")


# ---------------------------------------------------------------------------
# compute_eigensnp_pca.


def test_eigensnp_matches_reference_and_exact(tmp_path, rng):
    """The reference test's setting (tests/test_eigensnp.py:70-102): 8
    populations, all samples in the subset, two refinement passes."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=800, n_samples=100, n_pops=8, fst=0.25)
    algo = EigenSnpConfig(k_global=5, components_per_block=12, subset_factor=1.0,
                          min_subset_size=10, max_subset_size=100_000,
                          refine_passes=2, seed=2025, snp_strip_size=200)
    pt = tprep.prepare_data(cfg)
    res = tes.compute_eigensnp_pca(pt, algo, device="cpu")
    ref = jes.compute_eigensnp_pca(jprep.prepare_data(cfg), algo)
    exact = _exact(pt, cfg, 5)
    assert res.scores.shape == (100, 5) and res.loadings.shape == (pt.n_pca_snps, 5)
    assert res.scores.dtype == np.float32 and res.eigenvalues.dtype == np.float64
    for j in range(5):
        assert abs_corr(res.scores[:, j], ref.scores[:, j]) > 0.999, j
        assert abs_corr(res.scores[:, j], exact.scores[:, j]) > 0.999, j
        assert abs_corr(res.loadings[:, j], ref.loadings[:, j]) > 0.999, j
    # eigenvalues: sigma^2 / (N - 1) here, sigma^2 / D in the oracle
    np.testing.assert_allclose(res.eigenvalues / exact.eigenvalues,
                               pt.n_pca_snps / (100 - 1), rtol=2e-2)
    np.testing.assert_allclose(res.eigenvalues, ref.eigenvalues, rtol=5e-3)
    assert set(res.stage_seconds) == {"open", "qc_scan", "ld_map", "matrix_load",
                                      "stages_1_2", "global_pca",
                                      "refinement_finalize"}


@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_eigensnp_with_a_subset_in_both_modes(tmp_path, rng, monkeypatch, mode):
    """A 30-sample subset of 60 (reference: tests/test_eigensnp.py:115-136),
    in each container mode: refinement recovers the full-sample PCs."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=400, n_samples=60, n_pops=5, fst=0.25)
    algo = EigenSnpConfig(k_global=3, subset_factor=0.5, min_subset_size=10,
                          max_subset_size=30, refine_passes=2, snp_strip_size=128)
    pt = tprep.prepare_data(cfg)
    monkeypatch.setattr(ts, "default_mode", lambda n_pad, precision, packed: mode)
    subset = tes._choose_sample_subset(algo, 60)
    assert len(subset) == 30 and np.all(np.diff(subset) > 0)
    res = tes.compute_eigensnp_pca(pt, algo, device="cpu")
    exact = _exact(pt, cfg, 3)
    for j in range(2):
        assert abs_corr(res.scores[:, j], exact.scores[:, j]) > 0.995, j


def test_eigensnp_keep_list_matches_reference(tmp_path, rng):
    _, _, cfg = _setup(tmp_path, rng, n_snps=400, n_samples=64, n_pops=4, fst=0.25)
    keep = tmp_path / "keep.txt"
    keep.write_text("".join(f"sample{i}\n" for i in range(0, 64, 2)))
    cfg = dataclasses.replace(cfg, sample_keep_path=str(keep))
    algo = EigenSnpConfig(k_global=3, components_per_block=3, min_subset_size=32,
                          refine_passes=2)
    res = tes.compute_eigensnp_pca(tprep.prepare_data(cfg), algo, device="cpu")
    ref = jes.compute_eigensnp_pca(jprep.prepare_data(cfg), algo)
    assert res.scores.shape == (32, 3)
    for j in range(3):
        assert abs_corr(res.scores[:, j], ref.scores[:, j]) > 0.999, j


def test_pca_core_refinement_matches_per_pass_path(tmp_path, rng):
    """The production path (one pca_core) and the per-pass path that
    diagnostics take give the same PCs."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=500, n_samples=60, n_pops=4, fst=0.25)
    prep = tprep.prepare_data(cfg)
    algo = EigenSnpConfig(k_global=3, components_per_block=4, min_subset_size=60,
                          refine_passes=2)
    fused = tes.compute_eigensnp_pca(prep, algo, device="cpu")
    per_pass = tes.compute_eigensnp_pca(
        prep, dataclasses.replace(algo, collect_diagnostics=True), device="cpu")
    assert fused.diagnostics is None and per_pass.diagnostics is not None
    np.testing.assert_allclose(per_pass.eigenvalues, fused.eigenvalues, rtol=1e-3)
    for j in range(3):
        assert abs_corr(fused.scores[:, j], per_pass.scores[:, j]) > 0.9999, j
        assert abs_corr(fused.loadings[:, j], per_pass.loadings[:, j]) > 0.9999, j


def test_checkpoint_legs_give_the_one_run_result(tmp_path, rng):
    """stop-after legs (stage1_bases, stage2_basis, refine_pass_0), then a
    resume, give what one checkpointed run gives; a retried leg exits."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=300, n_samples=50)
    prep = tprep.prepare_data(cfg)
    algo = EigenSnpConfig(k_global=3, min_subset_size=10, refine_passes=2)
    one = tes.compute_eigensnp_pca(prep, algo, device="cpu",
                                   checkpoint_dir=str(tmp_path / "one"))
    legs = str(tmp_path / "legs")
    for stop in ("stage1_bases", "stage2_basis", "refine_pass_0"):
        assert tes.compute_eigensnp_pca(prep, algo, device="cpu",
                                        checkpoint_dir=legs,
                                        stop_after_checkpoint=stop) is None
        assert (Path(legs) / f"{stop}.npz").exists()
    # A retried leg finds its (or a later) checkpoint and exits.
    assert tes.compute_eigensnp_pca(prep, algo, device="cpu", checkpoint_dir=legs,
                                    stop_after_checkpoint="stage1_bases") is None
    last = tes.compute_eigensnp_pca(prep, algo, device="cpu", checkpoint_dir=legs)
    np.testing.assert_allclose(last.scores, one.scores, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(last.loadings, one.loadings, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(last.eigenvalues, one.eigenvalues, rtol=1e-6)
    with pytest.raises(ComputeError, match="requires a checkpoint_dir"):
        tes.compute_eigensnp_pca(prep, algo, device="cpu",
                                 stop_after_checkpoint="stage1_bases")
    with pytest.raises(ComputeError, match="not a checkpoint"):
        tes.compute_eigensnp_pca(prep, algo, device="cpu", checkpoint_dir=legs,
                                 stop_after_checkpoint="refine_pass_5")


def test_diagnostics_match_golden_schema(tmp_path, rng):
    """The diagnostics JSON has the reference's structure
    (tests/golden/eigensnp_diagnostics_schema.json) and its invariants;
    the block trace's projection is its basis over the standardized
    block."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=200, n_samples=40)
    prep = tprep.prepare_data(cfg)
    algo = EigenSnpConfig(k_global=3, min_subset_size=10, collect_diagnostics=True,
                          snp_strip_size=128, refine_passes=2,
                          diagnostic_block_tag=prep.blocks[1].tag)
    diag = tes.compute_eigensnp_pca(prep, algo, device="cpu").diagnostics

    def schema(x):
        if isinstance(x, dict):
            return {k: schema(v) for k, v in sorted(x.items())}
        if isinstance(x, list):
            return [schema(x[0])] if x else []
        return type(x).__name__

    assert json.loads(json.dumps(schema(diag))) == json.loads(GOLDEN.read_text())
    g = diag["global"]
    assert len(g["condensed_spectrum"]) == g["condensed_features"]
    assert len(g["final_eigenvalues"]) == g["k_global"] == 3
    assert g["refine_width"] >= g["k_global"]
    assert len(diag["refinement"]["subspace_residual_per_pass"]) == 2
    spec = g["condensed_spectrum"]
    assert all(a >= b - 1e-6 for a, b in zip(spec, spec[1:]))
    assert diag["matrix_path"] == "device-resident"
    for b in diag["blocks"]:
        assert len(b["local_singular_values"]) == b["num_local_components"]
    tr = diag["block_trace"]
    u = np.asarray(tr["local_basis"])
    assert u.shape == (tr["num_snps"], tr["num_local_components"])
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=5e-4)
    sm = prep.load_matrix("cpu")
    ids = np.asarray(tr["pca_snp_ids"])
    x = sm.fetch_blocks_device(ids[:1], np.array([len(ids)]), len(ids))[0, :, :40]
    np.testing.assert_allclose(np.asarray(tr["condensed_projection"]),
                               u.T @ x.numpy(), rtol=1e-3, atol=5e-3)
    with pytest.raises(ComputeError, match="matches no LD block"):
        tes.compute_eigensnp_pca(
            prep, EigenSnpConfig(k_global=3, diagnostic_block_tag="nope:0-1"),
            device="cpu")


def test_block_trace_of_a_block_at_the_matrix_end(tmp_path, rng):
    """The last block's bucket (512 rows) passes the last of 2,048 rows;
    its traced basis is still its SNPs in order: orthonormal, and its
    projection is the basis over the standardized block.  (The reference
    moves that block's window back, and its trace then slices the wrong
    rows; ROADMAP Queue 3.)"""
    _, _, cfg = _setup(tmp_path, rng, n_snps=2048, n_samples=40, n_blocks=1,
                      missing_rate=0.0, fst=0.2)
    (tmp_path / "blocks.tsv").write_text(f"1 1 19000\n1 19001 {2048 * 10}\n")
    prep = tprep.prepare_data(dataclasses.replace(cfg, min_maf=0.0, max_hwe_p=1.0))
    tag = prep.blocks[-1].tag
    assert int(prep.blocks[-1].pca_snp_ids[0]) + 512 > prep.n_pca_snps
    tr = tes.compute_eigensnp_pca(
        prep, EigenSnpConfig(k_global=3, min_subset_size=40, diagnostic_block_tag=tag),
        device="cpu").diagnostics["block_trace"]
    u = np.asarray(tr["local_basis"])
    np.testing.assert_allclose(u.T @ u, np.eye(u.shape[1]), atol=5e-4)
    ids = np.asarray(tr["pca_snp_ids"])
    raw = prep.bed.read(prep.pca_snp_orig_indices[ids]).astype(np.float64)
    x = (raw - prep.mean[ids, None]) / prep.std[ids, None]
    np.testing.assert_allclose(np.asarray(tr["condensed_projection"]), u.T @ x,
                               rtol=1e-3, atol=5e-3)


def test_no_blocks_and_non_contiguous_blocks_raise(tmp_path, rng):
    _, _, cfg = _setup(tmp_path, rng, n_snps=300, n_samples=30)
    empty = tmp_path / "empty.tsv"
    empty.write_text("9 1 10\n")
    with pytest.raises(ComputeError, match="No PCA SNPs"):
        tes.compute_eigensnp_pca(
            tprep.prepare_data(dataclasses.replace(cfg, ld_block_path=str(empty))),
            EigenSnpConfig(k_global=3), device="cpu")
    nested = tmp_path / "nested.tsv"
    nested.write_text("1 1001 1600\n1 1 3010\n")  # inner first: a hole in outer
    prep = tprep.prepare_data(dataclasses.replace(cfg, ld_block_path=str(nested)))
    assert tes._blocks_as_runs(prep.blocks) is None
    # Such a block file now runs through the host-accessor stages 1-2
    # (tests/test_torch_streaming.py holds them to the JAX package).
    res = tes.compute_eigensnp_pca(prep, EigenSnpConfig(k_global=3), device="cpu")
    assert res.scores.shape == (30, 3) and np.isfinite(res.scores).all()
    assert res.container == "device-resident"


# ---------------------------------------------------------------------------
# The workflow: the reference's files.


def _read_tsv(path):
    lines = Path(path).read_text().splitlines()
    rows = [ln.split("\t") for ln in lines[1:]]
    return lines[0].split("\t"), rows


def test_workflow_writes_the_reference_files(tmp_path, rng):
    _, _, cfg = _setup(tmp_path, rng, n_snps=600, n_samples=60, n_pops=4, fst=0.25)
    algo = EigenSnpConfig(k_global=3, components_per_block=4, min_subset_size=60,
                          refine_passes=2, collect_diagnostics=True)
    ref_p, port_p = str(tmp_path / "ref"), str(tmp_path / "port")
    jax_run_eigensnp(cfg, algo, ref_p, write_moments=True)
    run_eigensnp_workflow(cfg, algo, port_p, write_moments=True, device="cpu")
    for suffix in ("eigensnp.pca.tsv", "eigenvalues.tsv", "eigensnp.loadings.tsv"):
        h_ref, r_ref = _read_tsv(f"{ref_p}.{suffix}")
        h_port, r_port = _read_tsv(f"{port_p}.{suffix}")
        assert h_port == h_ref, suffix
        assert len(r_port) == len(r_ref), suffix
        n_lead = {"eigensnp.pca.tsv": 1, "eigenvalues.tsv": 1,
                  "eigensnp.loadings.tsv": 3}[suffix]
        assert [r[:n_lead] for r in r_port] == [r[:n_lead] for r in r_ref], suffix
        v_ref = np.array([r[n_lead:] for r in r_ref], float)
        v_port = np.array([r[n_lead:] for r in r_port], float)
        if suffix == "eigenvalues.tsv":
            np.testing.assert_allclose(v_port, v_ref, rtol=5e-3)
        else:
            for j in range(3):
                assert abs_corr(v_port[:, j], v_ref[:, j]) > 0.999, (suffix, j)
    # Moments derive from exact QC counts: the same bytes.
    assert (Path(f"{port_p}.eigensnp.moments.tsv").read_bytes()
            == Path(f"{ref_p}.eigensnp.moments.tsv").read_bytes())
    diag = json.loads(Path(f"{port_p}.eigensnp_diagnostics.json").read_text())
    assert diag["num_qc_samples"] == 60


def test_workflow_stopped_leg_writes_nothing(tmp_path, rng):
    _, _, cfg = _setup(tmp_path, rng, n_snps=300, n_samples=40)
    out = tmp_path / "out"
    run_eigensnp_workflow(cfg, EigenSnpConfig(k_global=3, min_subset_size=10),
                          str(out), checkpoint_dir=str(tmp_path / "ck"),
                          stop_after_checkpoint="stage2_basis", device="cpu")
    assert not list(tmp_path.glob("out*"))
    assert (tmp_path / "ck" / "stage2_basis.npz").exists()

"""Port container, glue and helpers against the JAX package.

`genomic_pca_tpu_torch.parallel.sharded.ShardedMatrix` on the CPU (plain
kernel versions) against the JAX `ShardedMatrix` holding the same bytes:
in `mode="xla"` (f32) and `mode="pallas_interpret"` (q8 steering + bf16
polish, as the JAX tests run its kernels).  The JAX sketch is passed to
both, so the comparison is of the algorithm, not of random draws.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.models import pca as jpca
from genomic_pca_tpu.ops import qc as jqc
from genomic_pca_tpu.ops import rsvd as jrsvd
from genomic_pca_tpu.parallel import sharded as js
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu.utils import rng as jrng
from genomic_pca_tpu_torch.models import pca as tpca
from genomic_pca_tpu_torch.ops import qc as tqc
from genomic_pca_tpu_torch.ops import rsvd as trsvd
from genomic_pca_tpu_torch.parallel import sharded as ts
from genomic_pca_tpu_torch.utils import rng as trng
from tests.conftest import make_genotypes
from tests.torch_cases import abs_corr, exact_pcs

# ---------------------------------------------------------------------------
# Host helpers: bit-equal to the reference.


@pytest.mark.parametrize("n", [1, 3, 4, 5, 511, 512, 513, 2504])
def test_packed_cols_matches_reference(n):
    assert ts.packed_cols(n) == js.packed_cols(n)


@pytest.mark.parametrize("n", [1, 2, 3, 4, 7, 37])
def test_pack_and_sanitize_bit_equal(rng, n):
    geno = make_genotypes(rng, 11, n, missing_rate=0.2)
    np.testing.assert_array_equal(ts.pack_int8_rows(geno), js.pack_int8_rows(geno))
    raw = rng.integers(0, 256, size=(6, -(-n // 4)), dtype=np.uint8)
    np.testing.assert_array_equal(
        ts.sanitize_partial_byte(raw, n), js.sanitize_partial_byte(raw, n)
    )
    assert ts.PACKED_MISSING_BYTE == js.PACKED_MISSING_BYTE


def test_inv_std_and_q8_polish_match_reference(rng):
    s = rng.uniform(0, 2, 50).astype(np.float32)
    s[[0, 7]] = 0.0
    got, ref = ts.inv_std_of(s), js.inv_std_of(s)
    assert got.dtype == ref.dtype
    np.testing.assert_array_equal(got, ref)
    for args in [(None, None), (None, 0.02), (None, 0.1), (3, 0.0), (1, 0.5)]:
        assert ts.resolve_q8_polish(*args) == js.resolve_q8_polish(*args)
    with pytest.raises(ValueError):
        ts.resolve_q8_polish(0, None)


def test_qc_helpers_bit_equal(rng):
    g = make_genotypes(rng, 30, 41, missing_rate=0.1)
    counts = tqc.genotype_counts_int8_host(g)
    np.testing.assert_array_equal(counts, jqc.genotype_counts_int8_host(g))
    np.testing.assert_array_equal(
        tqc.dosage_mean_from_counts(counts), jqc.dosage_mean_from_counts(counts)
    )


def test_lane_fill_and_validate_k_match_reference():
    for ell, n, d in [(20, 2504, 16384), (20, 50, 30), (130, 1000, 900), (5, 3, 9)]:
        assert tpca.lane_fill_width(ell, n, d) == jpca.lane_fill_width(ell, n, d)
    for k, n, d in [(10, 100, 50), (80, 60, 70), (3, 2, 5)]:
        assert tpca.validate_k(k, n, d) == jpca.validate_k(k, n, d)
    from genomic_pca_tpu_torch.errors import ComputeError

    for bad in [(0, 10, 10), (2, 1, 10), (2, 10, 0)]:
        with pytest.raises(ComputeError):
            tpca.validate_k(*bad)


def test_stage_generators():
    assert trng.STAGE_IDS == jrng.STAGE_IDS
    a = trng.normal((5, 3), 42, "rfit_sketch", "cpu")
    np.testing.assert_array_equal(a, trng.normal((5, 3), 42, "rfit_sketch", "cpu"))
    assert not torch.equal(a, trng.normal((5, 3), 43, "rfit_sketch", "cpu"))
    assert not torch.equal(a, trng.normal((5, 3), 42, "bench", "cpu"))
    assert not torch.equal(a, trng.normal((5, 3), 42, "rfit_sketch", "cpu", unit=1))


# ---------------------------------------------------------------------------
# Glue: ops/rsvd.py.


def test_quantize_basis_bit_equal(rng):
    bp = rng.standard_normal((64, 16)).astype(np.float32)
    bp[40:] = 0.0
    ref = [np.asarray(x) for x in jrsvd.quantize_basis(jnp.asarray(bp))]
    got = [x.numpy() for x in trsvd.quantize_basis(torch.from_numpy(bp))]
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_cholqr2_and_residual_match_reference(rng):
    t = rng.standard_normal((200, 12)).astype(np.float32)
    t[:, 3] *= 1e3
    t[:, 11] = 0.0  # a zero (padding) column stays zero and finite
    q = trsvd.cholqr2_q(torch.from_numpy(t)).numpy()
    np.testing.assert_allclose(q, np.asarray(jrsvd.cholqr2_q(jnp.asarray(t))),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(q[:, :11].T @ q[:, :11], np.eye(11), atol=1e-5)
    assert np.all(q[:, 11] == 0.0)
    b = np.linalg.qr(rng.standard_normal((200, 12)))[0].astype(np.float32)
    got = float(trsvd.subspace_residual(torch.from_numpy(b), torch.from_numpy(t)))
    ref = float(jrsvd.subspace_residual(jnp.asarray(b), jnp.asarray(t)))
    assert got == pytest.approx(ref, rel=1e-5)


# ---------------------------------------------------------------------------
# The container against the JAX container on the same bytes.


def _moments(g):
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    cnt = valid.sum(axis=1)
    mean = (g0.sum(axis=1) / cnt).astype(np.float32)
    std = np.sqrt((((g0 - mean[:, None]) ** 2) * valid).sum(axis=1)
                  / (cnt - 1)).astype(np.float32)
    return mean, std


def _pair(rng, mode, precision, d=500, n=70, n_pops=3, fst=0.2, tile_d=128):
    """JAX container (1-device mesh) and the port container holding its
    arrays verbatim; the port's q8 tile is the one the JAX container
    picks for its packed q8 kernel."""
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=n_pops, fst=fst)
    mean, std = _moments(g)
    sm_j = js.ShardedMatrix.from_packed_rows(
        js.pack_int8_rows(g), mean, std, n, mesh=make_mesh(jax.devices()[:1]),
        mode=mode, tile_d=tile_d, kernel_precision=precision,
    )
    geno = np.asarray(sm_j.geno)
    q8_tile = js._q8_packed_tile_d(geno.shape[0], geno.shape[1], 128, tile_d)
    sm_t = ts.ShardedMatrix.from_reference_arrays(
        geno, np.asarray(sm_j.mean), np.asarray(sm_j.inv_std), d, n, "cpu",
        tile_d=q8_tile, kernel_precision=precision,
    )
    return g, sm_j, sm_t


def test_from_packed_rows_and_strips_hold_reference_bytes(rng):
    d, n = 300, 37
    g = make_genotypes(rng, d, n, missing_rate=0.05)
    raw = js.pack_int8_rows(g)
    raw[:, -1] &= 0x3F  # PLINK zero-fill of the trailing field: must be sanitized
    mean = rng.random(d).astype(np.float32)
    std = rng.random(d).astype(np.float32) + 0.5
    std[4] = 0.0
    sm_j = js.ShardedMatrix.from_packed_rows(raw, mean, std, n,
                                             mesh=make_mesh(jax.devices()[:1]))
    sm_t = ts.ShardedMatrix.from_packed_rows(raw, mean, std, n, "cpu")
    np.testing.assert_array_equal(sm_t.geno.numpy(), np.asarray(sm_j.geno)[:d])
    np.testing.assert_array_equal(sm_t.mean.numpy(), np.asarray(sm_j.mean)[:d])
    np.testing.assert_array_equal(sm_t.inv_std.numpy(),
                                  np.asarray(sm_j.inv_std)[:d])
    sane = ts.sanitize_partial_byte(raw, n)
    sm_s = ts.ShardedMatrix.from_packed_strips(
        lambda lo, hi: sane[lo:hi], d, mean, std, n, "cpu", strip_rows=64
    )
    for a, b in [(sm_s.geno, sm_t.geno), (sm_s.mean, sm_t.mean),
                 (sm_s.inv_std, sm_t.inv_std)]:
        assert torch.equal(a, b)


@pytest.mark.parametrize("name", ["gram_apply", "tsq_accumulate", "right_apply"])
def test_passes_match_reference_f32(rng, name):
    _, sm_j, sm_t = _pair(rng, "xla", "f32")
    b = np.random.default_rng(5).standard_normal((70, 9)).astype(np.float32)
    b /= np.sqrt(70)
    ref = np.asarray(getattr(sm_j, name)(jnp.asarray(b)))
    got = getattr(sm_t, name)(torch.from_numpy(b))
    got = got if isinstance(got, np.ndarray) else got.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)


# q8: any f32-level difference in z can flip one 8-bit rounding, so the
# two implementations steer to slightly different bases; the reference's
# own q8 test holds eigenvalues to 5e-3 (tests/test_q8.py:112-114).
@pytest.mark.parametrize("mode,precision,s_rtol", [
    ("xla", "f32", 1e-4), ("pallas_interpret", "q8", 5e-3),
])
def test_power_iterate_and_pca_core_match_reference(rng, mode, precision,
                                                     s_rtol):
    _, sm_j, sm_t = _pair(rng, mode, precision, n_pops=4)
    b0 = np.random.default_rng(6).standard_normal((70, 8)).astype(np.float32)
    q_j = np.asarray(sm_j.power_iterate(jnp.asarray(b0), 4))
    q_t = tpca.power_iterate(sm_t, torch.from_numpy(b0), 4)[0].numpy()
    for j in range(3):  # the separated prefix (3 = n_pops - 1)
        assert abs_corr(q_j[:, j], q_t[:, j]) > 0.9999, j
    v_j, s_j, e_j, l_j = sm_j.pca_core(jnp.asarray(b0), 4, 3)
    v_t, s_t, e_t, l_t, _ = tpca.pca_core(sm_t, torch.from_numpy(b0), 4, 3)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=s_rtol)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2 * s_rtol)
    assert l_t.shape == l_j.shape == (500, 3)
    for j in range(3):
        assert abs_corr(np.asarray(v_j)[:, j], v_t.numpy()[:, j]) > 0.9999, j
        assert abs_corr(l_j[:, j], l_t[:, j]) > 0.9999, j


@pytest.mark.parametrize("tol,expect", [(10.0, 3), (0.0, 6)])
def test_tolerance_early_exit_matches_reference(rng, tol, expect):
    """tol = 10 exits after the second steering pass (the i > 0 guard
    rules out the first) plus the one mandatory polish pass; tol = 0
    runs every pass."""
    _, sm_j, sm_t = _pair(rng, "pallas_interpret", "q8")
    b0 = np.random.default_rng(7).standard_normal((70, 8)).astype(np.float32)
    _, n_j = sm_j.power_iterate(jnp.asarray(b0), 6, tolerance=tol)
    _, n_t = tpca.power_iterate(sm_t, torch.from_numpy(b0), 6, tolerance=tol)
    *_, n_core = tpca.pca_core(sm_t, torch.from_numpy(b0), 6, 3, tolerance=tol)
    assert n_t == n_j == n_core == expect


def test_q8_pca_matches_float64_oracle(rng):
    """The port's default path (q8 steering, bf16 polish) through
    streamed_pca against a float64 PCA: per-PC |r| > 0.999."""
    d, n, k = 1024, 192, 5
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=8, fst=0.12)
    v_true, evals, mean, std = exact_pcs(g, k)
    sm = ts.ShardedMatrix.from_packed_rows(
        ts.pack_int8_rows(g), mean.astype(np.float32), std.astype(np.float32),
        n, "cpu", tile_d=128,
    )
    res = tpca.streamed_pca(sm, k=k, n_power_iter=6, seed=11,
                            compute_loadings=True)
    assert res.loadings.shape == (d, k) and res.n_iter_done == 6
    for i in range(k):
        assert abs_corr(res.scores[:, i], v_true[:, i]) > 0.999, i
    np.testing.assert_allclose(res.eigenvalues * (n - 1), evals, rtol=1e-2)


def test_streamed_pca_needs_pca_core():
    class Bare:
        n_rows, n_samples = 10, 5

    with pytest.raises(TypeError, match="pca_core"):
        tpca.streamed_pca(Bare(), k=2)

"""The port's test-oracle container `ops/stream.py` `StripedMatrix` and
the plain power loop of `streamed_pca`, on the CPU.

`StripedMatrix` against the JAX `StripedMatrix` on the same strips
(moments and padded strips bit for bit, the three products at rtol /
atol 1e-5), its padding and centre-only invariance, `streamed_pca` over
it against the float64 oracle with and without `tolerance`, and the
port's two production containers (resident `ShardedMatrix` and
host-streamed `StreamingMatrix`, both layouts and modes, one rank) held
against it at the tolerances their tests hold them to the JAX containers.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops.stream import StripedMatrix as JStripedMatrix
from genomic_pca_tpu_torch.models import pca as tpca
from genomic_pca_tpu_torch.models.exact import exact_pca_from_strips
from genomic_pca_tpu_torch.ops.operator import StandardizedOperator, StandardizedProducts
from genomic_pca_tpu_torch.ops.stream import StripedMatrix
from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix
from genomic_pca_tpu_torch.parallel import sharded as ts
from tests.conftest import make_genotypes
from tests.test_torch_streaming import _source
from tests.torch_cases import abs_corr

PASSES = ["gram_apply", "tsq_accumulate", "right_apply"]
# The f32 bar of tests/test_torch_sharded.py::test_passes_match_reference_f32.
F32_TOL = (1e-4, 1e-4)


def _np(x):
    return x if isinstance(x, np.ndarray) else np.asarray(x)


def _split(geno, cuts):
    return [geno[a:b] for a, b in zip([0, *cuts], [*cuts, geno.shape[0]])]


def _dense(geno, center_only=False):
    """float64 A (D, N): missing imputed to the mean, then centred and,
    unless centre-only, scaled by the sample std (ddof 1)."""
    valid = geno != -127
    x = np.where(valid, geno, 0).astype(np.float64)
    cnt = valid.sum(axis=1)
    mean = x.sum(axis=1) / cnt
    a = np.where(valid, x - mean[:, None], 0.0)
    if not center_only:
        std = np.sqrt((a * a).sum(axis=1) / (cnt - 1))
        a /= np.where(std > 0, std, 1.0)[:, None]
    return a


@pytest.mark.parametrize("center_only", [False, True])
@pytest.mark.parametrize("cuts,strip", [((), 64), ((70,), 64), ((30, 95), 100)])
def test_strips_and_moments_bit_for_bit(rng, cuts, strip, center_only):
    geno = make_genotypes(rng, 130, 30, missing_rate=0.05)
    geno[7] = 1  # a monomorphic row: std 0, inv_std 0
    parts = _split(geno, cuts)
    sm_t = StripedMatrix.from_arrays(iter(parts), strip_size=strip,
                                     center_only=center_only, device="cpu")
    sm_j = JStripedMatrix.from_arrays(iter(parts), strip_size=strip,
                                      center_only=center_only)
    assert (sm_t.n_rows, sm_t.n_samples) == (sm_j.n_rows, sm_j.n_samples) == (130, 30)
    assert len(sm_t.strips) == len(sm_j.strips)
    for st, sj in zip(sm_t.strips, sm_j.strips):
        assert st.n_rows == sj.n_rows
        for name in ("geno", "mean", "inv_std"):
            got, ref = getattr(st, name).numpy(), np.asarray(getattr(sj, name))
            assert got.dtype == ref.dtype and got.shape == ref.shape == got.shape
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("center_only", [False, True])
@pytest.mark.parametrize("name", PASSES)
def test_passes_match_reference(rng, name, center_only):
    geno = make_genotypes(rng, 300, 40, missing_rate=0.03)
    parts = _split(geno, (70,))
    sm_t = StripedMatrix.from_arrays(iter(parts), strip_size=128,
                                     center_only=center_only, device="cpu")
    sm_j = JStripedMatrix.from_arrays(iter(parts), strip_size=128,
                                      center_only=center_only)
    b = np.linalg.qr(rng.standard_normal((40, 7)))[0].astype(np.float32)
    got = _np(getattr(sm_t, name)(torch.from_numpy(b)))
    ref = _np(getattr(sm_j, name)(jnp.asarray(b)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("center_only", [False, True])
def test_padding_and_center_only_invariance(rng, center_only):
    """Two strip layouts give the same products, which are the float64
    dense A's (centre-only: inv_std 1 on every real row)."""
    geno = make_genotypes(rng, 100, 20, missing_rate=0.02)
    sm_a = StripedMatrix.from_arrays(iter([geno]), strip_size=64,
                                     center_only=center_only, device="cpu")
    sm_b = StripedMatrix.from_arrays(iter(_split(geno, (30,))), strip_size=100,
                                     center_only=center_only, device="cpu")
    if center_only:
        assert all(float(s.inv_std[: s.n_rows].min()) == 1.0 for s in sm_a.strips)
    b = torch.from_numpy(rng.standard_normal((20, 3)).astype(np.float32))
    np.testing.assert_allclose(sm_a.gram_apply(b).numpy(), sm_b.gram_apply(b).numpy(),
                               rtol=1e-5, atol=1e-3)
    a = _dense(geno, center_only)
    np.testing.assert_allclose(sm_a.right_apply(b), a @ b.double().numpy(),
                               rtol=2e-4, atol=2e-4)
    np.testing.assert_allclose(sm_b.right_apply(b), sm_a.right_apply(b),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("tolerance", [None, 0.03])
def test_streamed_pca_plain_loop_matches_oracle(tolerance):
    """5 populations (the data of the streaming tests): per-PC |r| >
    0.999 against the port's float64 oracle over the eigengap-separated
    prefix, sigma^2 / kept within 1e-3 of the oracle's eigenvalues; with
    a tolerance the loop exits early.  The loadings come from
    `right_apply` and are unit columns."""
    geno = make_genotypes(np.random.default_rng(0), 1024, 192, missing_rate=0.02,
                          n_pops=5, fst=0.2)
    k = 4
    exact = exact_pca_from_strips(iter([geno]), 192, k=k + 1, scale=True,
                                  apply_qc=False, device="cpu")
    ev = exact.eigenvalues
    sep = next((j for j in range(k) if (ev[j] - ev[j + 1]) / ev[j] < 0.05), k)
    assert sep >= 3
    sm = StripedMatrix.from_arrays(iter([geno]), strip_size=256, device="cpu")
    res = tpca.streamed_pca(sm, k=k, n_power_iter=8, seed=42,
                            tolerance=tolerance, compute_loadings=True)
    if tolerance is None:
        assert res.n_iter_done == 8
    else:
        assert 2 <= res.n_iter_done < 8
    for j in range(sep):
        assert abs_corr(res.scores[:, j], exact.scores[:, j]) > 0.999, j
    np.testing.assert_allclose(res.singular_values[:sep] ** 2 / exact.n_kept_variants,
                               ev[:sep], rtol=1e-3)
    assert res.loadings.shape == (1024, k)
    np.testing.assert_allclose(np.linalg.norm(res.loadings, axis=0), 1.0, atol=1e-3)


def test_streamed_pca_refuses_an_operator_without_products():
    class Bare:
        n_rows, n_samples = 10, 5

    with pytest.raises(TypeError, match="gram_apply"):
        tpca.streamed_pca(Bare(), k=2)


# The production containers against the oracle, on the same bytes and moments.
CONTAINERS = [(kind, packed, mode) for kind in ("resident", "streaming")
              for packed in (True, False) for mode in ("1d", "2d")]


def _container(kind, g, packed, mode, precision):
    d, n = g.shape
    mean, std = ts.host_moments(g)
    if kind == "streaming":
        source, n_strips = _source(g, 128, packed)
        return StreamingMatrix(source, n_strips=n_strips, n_rows=d, n_samples=n,
                               strip_size=128, mode=mode, packed=packed,
                               kernel_precision=precision, device="cpu")
    kw = dict(mode=mode, kernel_precision=precision)
    if packed:
        return ts.ShardedMatrix.from_packed_rows(ts.pack_int8_rows(g), mean, std, n,
                                                 "cpu", **kw)
    return ts.ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                        device="cpu", **kw)


@pytest.mark.parametrize("kind,packed,mode", CONTAINERS)
def test_containers_give_the_core_its_passes(kind, packed, mode, monkeypatch):
    """Each production container is a `StandardizedOperator` (the oracle
    has the products alone), and the core runs the same pass sequence on
    each: under a tolerance the q8 steering exits after its second pass
    (the first cannot), the `q8_polish` exact passes run in full, and the
    pass count says so; without one every pass runs."""
    g = make_genotypes(np.random.default_rng(3), 300, 200, missing_rate=0.05)
    mean, std = ts.host_moments(g)
    oracle = StripedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                       strip_size=128, device="cpu")
    assert isinstance(oracle, StandardizedProducts)
    assert not isinstance(oracle, StandardizedOperator)
    sm = _container(kind, g, packed, mode, "q8")
    assert isinstance(sm, StandardizedOperator)
    assert sm.resident == (kind == "resident")
    seen = []
    for name in ("q8_pass", "exact_pass"):
        def spy(b, name=name, run=getattr(sm, name)):
            seen.append(name)
            return run(b)
        monkeypatch.setattr(sm, name, spy)
    b0 = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (200, 8)).astype(np.float32))
    polish = ["exact_pass"] * sm.q8_polish
    q, done = tpca.power_iterate(sm, b0, 6, tolerance=10.0)
    assert seen == ["q8_pass"] * 2 + polish and done == 2 + sm.q8_polish
    assert q.shape == (200, 8)
    np.testing.assert_allclose(q.T @ q, np.eye(8), atol=1e-5)
    seen.clear()
    *_, loadings, done = tpca.pca_core(sm, b0, 6, 3, tolerance=0.0)
    assert seen == ["q8_pass"] * (6 - sm.q8_polish) + polish and done == 6
    assert loadings.shape == (300, 3)


@pytest.mark.parametrize("name", PASSES)
@pytest.mark.parametrize("kind,packed,mode", CONTAINERS)
def test_containers_match_the_oracle(kind, packed, mode, name):
    """Each pass of each container in f32 mode (a ragged last strip of 44
    rows, 5% missing) against `StripedMatrix` over the same moments, at
    the f32 bar the resident container is held to the JAX one."""
    g = make_genotypes(np.random.default_rng(3), 300, 200, missing_rate=0.05)
    mean, std = ts.host_moments(g)
    oracle = StripedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                       strip_size=128, device="cpu")
    sm = _container(kind, g, packed, mode, "f32")
    assert sm.mode == mode and sm.packed == packed
    b = np.random.default_rng(4).standard_normal((200, 9)).astype(np.float32)
    b /= np.sqrt(200)
    got = _np(getattr(sm, name)(torch.from_numpy(b)))
    ref = _np(getattr(oracle, name)(torch.from_numpy(b)))
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, *F32_TOL)

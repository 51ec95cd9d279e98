"""The 1-D Rayleigh-Ritz tsq pass (A B)^T (A B) (kernels 3 and 12) of the
port against the JAX package's.

On a CUDA tensor the bf16 pass runs as one C call of two tensor-core
products: W = A B stored as bf16 (each f32 sum rounded once, the gram
pass's right half), then W^T W (`ops/kernels.py` `_launch_tsq`).  Here, on
the CPU, the wrappers run the plain versions: the plain tsq must be
exactly that composition (plain right product, `_round_bf16`, W^T W), and
must match the JAX `fused_tsq_packed` / `fused_tsq` in interpret mode at
the reference tests' tsq bars.  The card's side is
`tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu_torch.ops import build
from genomic_pca_tpu_torch.ops import kernels as tk
from tests.test_torch_gram1d import ELLS, SHAPES, _case, _t

# The reference's own bars for its tsq kernels (tests/test_packed_kernels.py,
# tests/test_torch_kernels.py:32-35): the operands are rounded at the same
# points on both sides, but the f32 sums run in another order, and in bf16
# a W entry at a rounding tie may round one bf16 ulp apart; the (L, L)
# entries off the diagonal carry cancellation.
TOL = {"f32": (1e-4, 1e-3), "bf16": (1e-2, 2e-2)}
TSQ = {"packed": tk.fused_tsq_packed, "dense": tk.fused_tsq}
JAX_TILE = 512


def _jax(layout, geno, mu, inv, b, precision):
    """W^T W of the JAX tsq kernel of the layout in interpret mode, on rows
    padded with inert missing codes to a multiple of its row tile; packed
    B in plane-major order (the Gram of W is sample-order invariant)."""
    d = geno.shape[0]
    pad = -d % JAX_TILE
    fill = 0x55 if layout == "packed" else -127
    geno = np.concatenate([geno, np.full((pad, geno.shape[1]), fill, geno.dtype)])
    mu = np.concatenate([mu, np.zeros((pad, 1), np.float32)])
    inv = np.concatenate([inv, np.zeros((pad, 1), np.float32)])
    args = [jnp.asarray(x) for x in (geno, mu, inv)]
    kw = {"tile_d": JAX_TILE, "precision": precision, "interpret": True}
    if layout == "dense":
        return np.asarray(pk.fused_tsq(*args, jnp.asarray(b), **kw))
    perm = pk.plane_major_perm(b.shape[0])
    return np.asarray(pk.fused_tsq_packed(*args, jnp.asarray(b[perm]), **kw))


@pytest.mark.parametrize("ell", ELLS)
@pytest.mark.parametrize("d,n", SHAPES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_plain_tsq_is_right_then_round_then_wtw(layout, precision, d, n, ell):
    """Bit for bit on the CPU: the plain tsq is the plain right product, W
    rounded to bf16 once (bf16 mode only), then W^T W: the composition the
    kernel path computes in one call."""
    geno, mu, inv, b = (_t(x) for x in _case(d + ell, layout, d, n, ell))
    got = tk.PLAIN[TSQ[layout].__name__](geno, mu, inv, b, precision)
    w = tk.fused_right_apply_packed_plain(geno, mu, inv, b, precision)
    if precision == "bf16":
        w = tk._round_bf16(w)
    assert got.shape == (ell, ell)
    assert torch.equal(got, w.T @ w)


@pytest.mark.parametrize("ell", ELLS)
@pytest.mark.parametrize("d,n", SHAPES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_tsq_matches_jax_kernel(layout, precision, d, n, ell):
    """The port's tsq wrapper (plain version on the CPU) against the JAX
    kernel of the same layout in interpret mode, at the reference tests'
    tsq bars, over ragged rows past several folds and L below, at and past
    the 128-column tile."""
    geno, mu, inv, b = _case(d + ell, layout, d, n, ell)
    ref = _jax(layout, geno, mu, inv, b, precision)
    got = TSQ[layout](_t(geno), _t(mu), _t(inv), _t(b), precision=precision).numpy()
    rtol, atol = TOL[precision]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_tsq_on_a_cpu_tensor_runs_plain_and_counts_no_launch(layout):
    geno, mu, inv, b = (_t(x) for x in _case(3, layout, 300, 64, 10))
    tk.reset_launch_counts()
    got = TSQ[layout](geno, mu, inv, b)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert torch.equal(got, tk.PLAIN[TSQ[layout].__name__](geno, mu, inv, b, "bf16"))


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_tsq_refuses_a_wrong_b(layout):
    """B must be f32 (N, L) over the padded samples, on the genotypes'
    device; the precision bf16 or f32."""
    geno, mu, inv, b = (_t(x) for x in _case(4, layout, 100, 64, 10))
    fn = TSQ[layout]
    with pytest.raises(TypeError, match="float32"):
        fn(geno, mu, inv, b.double())
    with pytest.raises(ValueError, match="b must be"):
        fn(geno, mu, inv, b[:-4])
    with pytest.raises(ValueError, match="b must be"):
        fn(geno, mu, inv, b[:, 0])
    with pytest.raises(ValueError, match="precision"):
        fn(geno, mu, inv, b, precision="fp8")


@pytest.mark.parametrize("sms", [None, 132])
def test_tsq_plan_without_cuda_raises_as_gram_plan_does(monkeypatch, tmp_path, sms):
    """The plans are read from the built kernel library: without CUDA (no
    device for the SM count, no nvcc to build with) `tsq_plan` raises the
    error `gram_plan` raises, and reports no plan.  (This file imports jax,
    so it runs on the CPU machines, which have neither.)"""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    errors = []
    for plan in (tk.gram_plan, tk.tsq_plan):
        with pytest.raises(Exception) as info:
            plan(262_144, 512, 2_048, 128, sms)
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_mma2d_ab_tsq_checks_through_the_wrappers_and_needs_cuda(monkeypatch):
    """The A/B timer's tsq line (`eval/mma2d_ab.py`) holds both layouts of
    the tsq pass to their references through the wrappers before it times
    anything: on the CPU the right half is the plain right product, so its
    W ties are none and the reference is the float64 W^T W of the plain
    bf16 W.  It exits 1 without a CUDA device."""
    from genomic_pca_tpu_torch.eval import mma2d_ab

    cpu = torch.device("cpu")
    for layout in ("packed", "dense"):
        for shape in mma2d_ab.CHECKS["tsq"][:2]:
            assert mma2d_ab.agrees("tsq", layout, *shape, cpu)
        geno, mu, inv, b = (_t(x) for x in _case(5, layout, 1100, 132, 130))
        ref, w_err, ties, allow = mma2d_ab.tsq_reference(geno, mu, inv, b)
        assert w_err == 0.0 and not ties.any() and not allow.any()
        w = tk._round_bf16(tk.fused_right_apply_packed_plain(geno, mu, inv, b)).double()
        assert torch.equal(ref, w.T @ w)
        plain = tk.PLAIN[TSQ[layout].__name__](geno, mu, inv, b, "bf16")
        assert float((plain.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mma2d_ab.main(["tag", "--lines", "tsq"]) == 1

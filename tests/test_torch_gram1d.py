"""The 1-D gram pass A^T (A B) (kernels 2 and 10) of the port against the
JAX package's.

On a CUDA tensor the bf16 pass runs as one C call of two tensor-core
products: W = A B stored as bf16 (each f32 sum rounded once), then A^T W
(`ops/kernels.py` `_launch_gram`).  Here, on the CPU, the wrappers run the
plain versions: the plain gram must be exactly that composition (plain
right product, `_round_bf16`, plain 2-D left product), and must match the
JAX `fused_gram_apply_packed` / `fused_gram_apply` in interpret mode at the
reference tests' bars.  The card's side is `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows
from tests.conftest import make_genotypes

# (rows, samples): past two and three 1,024-row folds, ragged at the
# kernels' 64-row chunk, 128-sample tile and (130) the dense 4-sample word.
SHAPES = [(2500, 300), (1100, 130)]
ELLS = [10, 128, 130]
# The reference's own bars for its gram kernels, in both precisions
# (tests/test_packed_kernels.py:38-50): the operands are rounded at the
# same points on both sides, but the f32 sums over thousands of rows run
# in another order, which moves entries near zero by about 1e-4.  In bf16
# a W entry at a rounding tie may also round one bf16 ulp apart, which
# moves a column of the Gram by |A| ulp(W): that term is added entry by
# entry (`_tie_allowance`).
RTOL, ATOL = 1e-2, 1e-3
GRAM = {"packed": tk.fused_gram_apply_packed, "dense": tk.fused_gram_apply}
JAX_TILE = 512


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, layout, d, n, ell):
    """(genotypes as the port takes them, mean (d, 1), inv_std (d, 1), b):
    5% missing, an inert row, dense dosages outside {0, 1, 2} and its rows
    padded with -127 to a multiple of 4 samples; b over the padded
    samples (packed: 4 * ceil(n / 4))."""
    rng = np.random.default_rng(seed)
    g = make_genotypes(rng, d, n, missing_rate=0.05)
    if layout == "dense":
        odd = rng.random(g.shape) < 0.02
        g[odd] = rng.integers(-100, 100, size=int(odd.sum()))
        g = np.concatenate([g, np.full((d, -n % 4), -127, np.int8)], axis=1)
        geno = g
    else:
        geno = pack_int8_rows(g)
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    mu = (g0.sum(1) / np.maximum(valid.sum(1), 1)).astype(np.float32)[:, None]
    inv = (1.0 / (g0.std(1) + 0.1)).astype(np.float32)[:, None]
    inv[7] = 0.0
    n_pad = 4 * -(-n // 4)
    b = (rng.standard_normal((n_pad, ell)) / np.sqrt(n)).astype(np.float32)
    return geno, mu, inv, b


def _jax(layout, geno, mu, inv, b, precision):
    """(A^T (A B), A B) of the JAX gram and right kernels in interpret
    mode, on rows padded with inert missing codes to a multiple of their
    row tile; packed B in plane-major order and the Gram un-permuted
    (tests/test_torch_kernels.py).  The right kernel's tile computes the
    gram kernel's W = x b."""
    d = geno.shape[0]
    pad = -d % JAX_TILE
    fill = 0x55 if layout == "packed" else -127
    geno = np.concatenate([geno, np.full((pad, geno.shape[1]), fill, geno.dtype)])
    mu = np.concatenate([mu, np.zeros((pad, 1), np.float32)])
    inv = np.concatenate([inv, np.zeros((pad, 1), np.float32)])
    args = [jnp.asarray(x) for x in (geno, mu, inv)]
    kw = {"tile_d": JAX_TILE, "precision": precision, "interpret": True}
    if layout == "dense":
        gram = pk.fused_gram_apply(*args, jnp.asarray(b), **kw)
        w = pk.fused_right_apply(*args, jnp.asarray(b), **kw)
        return np.asarray(gram), np.array(w)[:d]
    perm = pk.plane_major_perm(b.shape[0])
    gram = pk.fused_gram_apply_packed(*args, jnp.asarray(b[perm]), **kw)
    w = pk.fused_right_apply_packed(*args, jnp.asarray(b[perm]), **kw)
    return np.asarray(gram)[np.argsort(perm)], np.array(w)[:d]


def _tie_allowance(geno, mu, inv, w_a, w_b):
    """|A|^T |bf16(W_a) - bf16(W_b)|: how far two bf16 Grams over the same
    A can lie apart where two f32 W round to different bf16 neighbours."""
    dw = (tk._round_bf16(_t(w_a)) - tk._round_bf16(_t(w_b))).abs()
    return (tk.standardize(_t(geno), _t(mu), _t(inv)).abs().T @ dw).numpy()


@pytest.mark.parametrize("ell", ELLS)
@pytest.mark.parametrize("d,n", SHAPES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_plain_gram_is_right_then_round_then_left(layout, precision, d, n, ell):
    """Bit for bit on the CPU: the plain gram is the plain right product,
    W rounded to bf16 once (bf16 mode only), then the plain 2-D left
    product: the composition the kernel path computes in one call."""
    geno, mu, inv, b = (_t(x) for x in _case(d + ell, layout, d, n, ell))
    got = tk.PLAIN[GRAM[layout].__name__](geno, mu, inv, b, precision)
    w = tk.fused_right_apply_packed_plain(geno, mu, inv, b, precision)
    if precision == "bf16":
        w = tk._round_bf16(w)
    want = tk.fused_left_apply_2d_packed_plain(geno, mu, inv, w, precision)
    assert got.shape == (b.shape[0], ell)
    assert torch.equal(got, want)


@pytest.mark.parametrize("ell", ELLS)
@pytest.mark.parametrize("d,n", SHAPES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_gram_matches_jax_kernel(layout, precision, d, n, ell):
    """The port's gram wrapper (plain version on the CPU) against the JAX
    kernel of the same layout in interpret mode, at the reference tests'
    bars (in bf16 plus the effect of W's rounding ties, whose count is
    bounded), over ragged rows past several folds and L below, at and past
    the 128-column tile."""
    geno, mu, inv, b = _case(d + ell, layout, d, n, ell)
    ref, w_ref = _jax(layout, geno, mu, inv, b, precision)
    args = (_t(geno), _t(mu), _t(inv), _t(b))
    got = GRAM[layout](*args, precision=precision).numpy()
    allow = 0.0
    if precision == "bf16":
        w = tk.fused_right_apply_packed_plain(*args, precision).numpy()
        np.testing.assert_allclose(w, w_ref, rtol=1e-5, atol=1e-5 * np.abs(w_ref).max())
        ties = tk._round_bf16(_t(w)) != tk._round_bf16(_t(w_ref))
        assert int(ties.sum()) <= 1e-3 * w.size
        allow = _tie_allowance(geno, mu, inv, w, w_ref)
    assert (np.abs(got - ref) <= ATOL + RTOL * np.abs(ref) + allow).all()


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_gram_on_a_cpu_tensor_runs_plain_and_counts_no_launch(layout):
    geno, mu, inv, b = (_t(x) for x in _case(3, layout, 300, 64, 10))
    tk.reset_launch_counts()
    got = GRAM[layout](geno, mu, inv, b)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert torch.equal(got, tk.PLAIN[GRAM[layout].__name__](geno, mu, inv, b, "bf16"))


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_gram_refuses_a_wrong_b(layout):
    """B must be f32 (N, L) over the padded samples, on the genotypes'
    device; the precision bf16 or f32."""
    geno, mu, inv, b = (_t(x) for x in _case(4, layout, 100, 64, 10))
    fn = GRAM[layout]
    with pytest.raises(TypeError, match="float32"):
        fn(geno, mu, inv, b.double())
    with pytest.raises(ValueError, match="b must be"):
        fn(geno, mu, inv, b[:-4])
    with pytest.raises(ValueError, match="b must be"):
        fn(geno, mu, inv, b[:, 0])
    with pytest.raises(ValueError, match="precision"):
        fn(geno, mu, inv, b, precision="fp8")


def test_mma2d_ab_gram_checks_through_the_wrappers_and_needs_cuda(monkeypatch):
    """The A/B timer's gram line (`eval/mma2d_ab.py`) holds both layouts of
    the gram pass to their references through the wrappers before it
    times anything: on the CPU the right half is the plain right product,
    so its W ties are none and the reference is the plain gram itself.
    It exits 1 without a CUDA device."""
    from genomic_pca_tpu_torch.eval import mma2d_ab

    cpu = torch.device("cpu")
    for layout in ("packed", "dense"):
        for shape in mma2d_ab.CHECKS["gram"][:2]:
            assert mma2d_ab.agrees("gram", layout, *shape, cpu)
        geno, mu, inv, b = (_t(x) for x in _case(5, layout, 1100, 132, 130))
        ref, w_err, ties = mma2d_ab.gram_reference(geno, mu, inv, b)
        assert w_err == 0.0 and not ties.any()
        assert torch.equal(ref, tk.PLAIN[GRAM[layout].__name__](geno, mu, inv, b,
                                                                 "bf16"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mma2d_ab.main(["tag"]) == 1

"""The q8 right product G0 bq of the 2-D mode (kernels 7 and 7i) on the CPU.

On a CUDA tensor `right_apply_2d_q8` runs the s8 tensor-core kernel
(csrc/q8_right2d_kernels.cu) over bq transposed (`q8_operand`), summing
each entry exactly in int32 and converting it once.  Here its plain
version and its operand run: both are held bit for bit to the JAX kernel
in interpret mode and to the int64 product, at ragged shapes; the sums
past 2^24 pin why a split of the samples adds int32 partials, never f32
ones.  The kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows

D, N = 200, 1100  # neither a multiple of the kernel's 128 rows or 256 samples


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(rng, d, n, ell):
    """Unstructured dosages {0, 1, 2} with 5% missing and row 7 all
    missing, and a random bq (n, ell): a swapped pair of samples would
    show."""
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -127
    g[7] = -127
    bq = rng.integers(-127, 128, size=(n, ell)).astype(np.int8)
    return g, bq


def _geno(g, layout):
    return pack_int8_rows(g) if layout == "packed" else g


def _exact(g, bq):
    """G0 bq in int64, converted to f32 once."""
    return (np.maximum(g, 0).astype(np.int64) @ bq.astype(np.int64)).astype(np.float32)


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("ell", [10, 128, 130])
def test_q8_operand_is_bq_transposed_with_zero_pads(rng, layout, ell):
    """bq^T, (L_pad, N_pad) int8 contiguous, L padded to 16 and N to the
    rows' width in samples (or 16); every pad entry 0; the plain product
    through it is the plain version's."""
    g, bq = _case(rng, D, N, ell)
    geno = _t(_geno(g, layout))
    samples = tk._samples(tk.aligned_rows(geno))
    for width in (None, samples):
        op = tk.q8_operand(_t(bq), width)
        n_pad = -(-(N if width is None else width) // 16) * 16
        assert op.dtype == torch.int8 and op.is_contiguous()
        assert tuple(op.shape) == (-(-ell // 16) * 16, n_pad)
        assert torch.equal(op[:ell, :N], _t(bq).T)
        pad = op.clone()
        pad[:ell, :N] = 0
        assert not bool(pad.any())
    whole = tk.q8_operand(_t(bq[:1024]), 1024)  # no pads: one transposed copy
    assert whole.is_contiguous() and torch.equal(whole[:ell], _t(bq[:1024]).T)
    assert tuple(whole.shape) == (-(-ell // 16) * 16, 1024)
    assert not bool(whole[ell:].any())
    g0 = tk.dosages_g0(geno)[:, :N].to(torch.int64)
    through = (g0 @ op[:ell, :N].T.to(torch.int64)).to(torch.float32)
    assert torch.equal(through, tk.right_apply_2d_q8_plain(geno, _t(bq)))
    np.testing.assert_array_equal(through.numpy(), _exact(g, bq))


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("ell", [10, 130])
def test_right_2d_q8_matches_jax_bit_for_bit(rng, layout, ell):
    """The port's right_apply_2d_q8 (its plain version on the CPU) against
    the JAX kernel in interpret mode at a ragged shape: bit for bit, and
    both equal the int64 product.  Packed, the JAX kernel takes bq in its
    tile-local plane-major order; int8, as it is."""
    g, bq = _case(rng, D, N, ell)
    geno = _geno(g, layout)
    if layout == "packed":
        tile = 25  # bytes: 275 = 11 tiles
        ref = pk.right_apply_2d_q8(
            jnp.asarray(geno), jnp.asarray(bq[pk.plane_major_perm_tiled(N, tile)]),
            tile_d=40, tile_n=tile, interpret=True)
    else:
        ref = pk.right_apply_2d_q8(jnp.asarray(geno), jnp.asarray(bq), tile_d=40,
                                   tile_n=100, interpret=True)
    tk.reset_launch_counts()
    got = tk.right_apply_2d_q8(_t(geno), _t(bq)).numpy()
    assert all(v == 0 for v in tk.LAUNCHES.values())
    np.testing.assert_array_equal(got, np.asarray(ref))
    np.testing.assert_array_equal(got, _exact(g, bq))
    assert np.all(got[7] == 0)


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_sums_past_2_24_need_an_integer_split_sum(layout):
    """A few rows x 70,000 samples, dosage 2 and bq 127 but for a few
    entries, so that |sum| passes 2^24 and most sums are odd: the plain
    version is the int64 product converted once; the kernel's split of
    the samples into ranges, int32 partials added in order and converted
    once, gives the same bits; f32 partials added in f32 do not."""
    rng = np.random.default_rng(24)
    d, n, ell = 3, 70_000, 16
    g = np.full((d, n), 2, np.int8)
    g[rng.random(g.shape) < 0.001] = 1
    bq = np.full((n, ell), 127, np.int8)
    bq[rng.random(bq.shape) < 0.001] = -5
    exact = np.maximum(g, 0).astype(np.int64) @ bq.astype(np.int64)
    assert exact.min() >= 2**24 and (exact % 2).any()
    got = tk.right_apply_2d_q8(_t(_geno(g, layout)), _t(bq)).numpy()
    np.testing.assert_array_equal(got, exact.astype(np.float32))
    # Ranges of 1,280 samples (55 of them), as the kernel's plan splits
    # these 3 rows on 132 SMs: 274 chunks of 256 samples, 5 a range.
    edges = list(range(0, n, 1280)) + [n]
    parts = [np.maximum(g[:, a:b], 0).astype(np.int64) @ bq[a:b].astype(np.int64)
             for a, b in zip(edges[:-1], edges[1:])]
    assert max(np.abs(p).max() for p in parts) < 2**31
    int_sum = np.zeros((d, ell), np.int32)
    f32_sum = np.zeros((d, ell), np.float32)
    for p in parts:
        int_sum += p.astype(np.int32)
        f32_sum += p.astype(np.float32)
    np.testing.assert_array_equal(int_sum.astype(np.float32), got)
    assert (f32_sum != got).any()


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_2d_q8_routes_and_validates(rng, layout):
    """A CPU tensor runs the plain version and counts no launch; a bq of
    another dtype or row count, or genotypes of another dtype or rank,
    raise before any launch."""
    g, bq = _case(rng, 40, 256, 10)
    geno, b = _t(_geno(g, layout)), _t(bq)
    tk.reset_launch_counts()
    assert torch.equal(tk.right_apply_2d_q8(geno, b), _t(_exact(g, bq)))
    assert all(v == 0 for v in tk.LAUNCHES.values())
    with pytest.raises(TypeError):
        tk.right_apply_2d_q8(geno, b.to(torch.int16))
    with pytest.raises(TypeError):
        tk.right_apply_2d_q8(geno, b.to(torch.float32))
    with pytest.raises(ValueError):
        tk.right_apply_2d_q8(geno, b[:-4])
    with pytest.raises(ValueError):
        tk.right_apply_2d_q8(geno[None], b)
    with pytest.raises(TypeError):
        tk.right_apply_2d_q8(geno.to(torch.int32), b)
    assert all(v == 0 for v in tk.LAUNCHES.values())


def test_mma2d_ab_q8right_checks_through_the_wrappers_and_needs_cuda(monkeypatch):
    """The A/B timer's q8 right line holds kernels 7 and 7i to their plain
    versions bit for bit through the wrapper before it times anything (on
    the CPU the wrapper runs the plain version, so it agrees at its check
    shapes), and the timer exits 1 without a CUDA device, whichever lines
    it is asked for."""
    from genomic_pca_tpu_torch.eval import mma2d_ab

    cpu = torch.device("cpu")
    for layout in mma2d_ab.LAYOUTS:
        assert mma2d_ab.agrees("q8right", layout, 70, 256, 10, cpu)
        assert mma2d_ab.agrees("q8right", layout, *mma2d_ab.CHECKS["q8right"][1], cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mma2d_ab.main(["tag", "--lines", "q8right"]) == 1
    assert mma2d_ab.main(["tag"]) == 1

"""The quantized (q8) power pass of kernels 1 and 9 (and of the 2-D mode)
on the CPU.

On a CUDA tensor `fused_gram_q8_packed` / `fused_gram_q8` make one C call
(csrc/q8_pass.cuh): W = G0 bq by kernel 7's s8 tensor-core product, the
requantization into z8^T by a kernel of its own, then kernel 8's s8
tensor-core left product with its row split.  Here the plain version of
the step between the products, `q8_requant_plain`, is pinned to the glue
it factors out and to a numpy float32 model of the kernel's arithmetic
(the same z8 and sz bits), and the plain pass at the row ranges the card's
plan may split into is held to the JAX kernels in interpret mode at an
equal tile.  The kernel itself is held to the plain version on the card in
tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu_torch.ops import build
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows
from tests.torch_cases import q8_case


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _requant_case(rng, d, ell):
    """W = G0 bq as the right product gives it (integers in f32) and the
    moments, basis scale and column sums of a pass."""
    w = rng.integers(-40_000, 40_000, size=(d, ell)).astype(np.float32)
    iv = rng.uniform(0.5, 2.0, (d, 1)).astype(np.float32)
    u = rng.uniform(0.0, 2.0, (d, 1)).astype(np.float32)
    sb = np.full((1, 1), rng.uniform(1e-3, 2e-2), np.float32)
    csum = (rng.integers(-3_000, 3_000, size=(1, ell)) * sb).astype(np.float32)
    return w, iv, u, sb, csum


def _glue(w, iv, u, sb, csum, tile_d):
    """The middle of a q8 pass as the torch glue between kernels 7 and 8
    computed it before the requantization had a name: y, z, then
    `quantize_rows`."""
    y = iv * (w * sb) - u * csum
    z8, sz = tk.quantize_rows(iv * y, tile_d)
    return z8, sz, (u * y).sum(dim=0, keepdim=True)


def _requant_f32_model(w, iv, u, sb, csum, tile_d):
    """The requantization kernel's arithmetic in numpy float32: each
    multiply and subtract rounded on its own, per row tile m = max|z|, sz =
    m * f32(1/127) + f32(1e-30), one reciprocal 1 / sz a tile, z8 =
    clamp(rint(z * (1 / sz))); ru summed per tile in row order, then the
    tiles' partials in tile order."""
    f32 = np.float32
    y = (iv * (w * sb)) - (u * csum)
    z = iv * y
    uy = u * y
    d, ell = z.shape
    z8 = np.empty((d, ell), np.int8)
    sz = np.empty(-(-d // tile_d), np.float32)
    ru = np.zeros(ell, np.float32)
    for t, lo in enumerate(range(0, d, tile_d)):
        zt = z[lo:lo + tile_d]
        s = f32(np.abs(zt).max()) * f32(1.0 / 127.0) + f32(1e-30)
        r = f32(1.0) / s
        z8[lo:lo + tile_d] = np.clip(np.rint(zt * r), -127, 127)
        sz[t] = s
        part = np.zeros(ell, np.float32)
        for row in uy[lo:lo + tile_d]:
            part = part + row
        ru = ru + part
    assert y.dtype == z.dtype == sz.dtype == np.float32
    return z8, sz, ru[None]


@pytest.mark.parametrize("d,tile_d", [(512, 64), (512, 128), (300, 64), (1000, 128)])
def test_q8_requant_plain_is_the_glue_bit_for_bit(rng, d, tile_d):
    """`q8_requant_plain` gives the glue's z8 and sz bit for bit, at tiles
    of 64 and 128 and a ragged last tile (300 = 4 x 64 + 44, 1,000 = 7 x
    128 + 104), and its ru within 1e-6 of max|ru|."""
    args = [_t(x) for x in _requant_case(rng, d, 128)]
    z8, sz, ru = tk.q8_requant_plain(*args, tile_d)
    z8_g, sz_g, ru_g = _glue(*args, tile_d)
    assert z8.dtype == torch.int8 and z8.shape == (d, 128)
    assert sz.dtype == torch.float32 and sz.shape == (-(-d // tile_d),)
    assert torch.equal(z8, z8_g) and torch.equal(sz, sz_g)
    assert ru.shape == (1, 128)
    assert float((ru - ru_g).abs().max()) <= 1e-6 * float(ru_g.abs().max())


@pytest.mark.parametrize("d,tile_d", [(512, 64), (300, 64), (1000, 128), (64, 64)])
def test_q8_requant_f32_model_gives_the_same_bits(rng, d, tile_d):
    """The numpy float32 model of the card's requantization (separate
    roundings, one reciprocal a tile, half-to-even rounding; ru per tile,
    then in tile order) gives `q8_requant_plain`'s z8 and sz bit for bit,
    and its ru within 1e-6 of max|ru|."""
    w, iv, u, sb, csum = _requant_case(rng, d, 128)
    z8_m, sz_m, ru_m = _requant_f32_model(w, iv, u, sb, csum, tile_d)
    z8, sz, ru = tk.q8_requant_plain(*map(_t, (w, iv, u, sb, csum)), tile_d)
    np.testing.assert_array_equal(z8.numpy(), z8_m)
    np.testing.assert_array_equal(sz.numpy().view(np.uint32), sz_m.view(np.uint32))
    assert np.abs(ru.numpy() - ru_m).max() <= 1e-6 * np.abs(ru_m).max()


def test_q8_requant_constants_are_torchs_scalars():
    """float32(1/127) and float32(1e-30), the constants the card's kernel
    writes as 1.0f / 127.0f and 1e-30f, are the f32 values torch computes
    with when it multiplies by 1.0 / 127.0 and adds 1e-30."""
    one = torch.ones(1)
    assert float(one * (1.0 / 127.0)) == float(np.float32(1.0) / np.float32(127.0))
    assert float(torch.zeros(1) + 1e-30) == float(np.float32(1e-30))


def _jax_pass(layout, g, iv, u, bq, sb, csum, tile_d):
    """T = out - ru of the JAX q8 pass in interpret mode, original sample
    order (the packed kernel's plane-major order undone)."""
    n = g.shape[1]
    if layout == "dense":
        out, ru = pk.fused_gram_q8(jnp.asarray(g), jnp.asarray(iv), jnp.asarray(u),
                                   jnp.asarray(bq), jnp.asarray(sb), jnp.asarray(csum),
                                   tile_d=tile_d, interpret=True)
        return np.asarray(out) - np.asarray(ru)
    perm = pk.plane_major_perm(n)
    out, ru = pk.fused_gram_q8_packed(
        jnp.asarray(pack_int8_rows(g)), jnp.asarray(iv), jnp.asarray(u),
        jnp.asarray(bq[perm]), jnp.asarray(sb), jnp.asarray(csum), tile_d=tile_d,
        interpret=True)
    return (np.asarray(out) - np.asarray(ru))[np.argsort(perm)]


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("ranges", [(0,), (0, 4), (0, 2, 4, 6)])
def test_q8_pass_plain_at_ranges_matches_jax(rng, layout, ranges):
    """The port's plain pass, folding its 8 row tiles at 1, 2 and 4 ranges
    (the card's plan may split the rows so), against the JAX kernel in
    interpret mode at an equal tile, to the reference tests' bar (rtol
    1e-4, atol 1e-2); the split changes the bits."""
    d, n, ell, tile_d = 512, 512, 128, 64
    g, iv, u, bq, sb, csum = q8_case(rng, d, n, ell, missing_rate=0.05)
    ref = _jax_pass(layout, g, iv, u, bq, sb, csum, tile_d)
    geno = pack_int8_rows(g) if layout == "packed" else g
    plain = tk.fused_gram_q8_packed_plain if layout == "packed" else tk.fused_gram_q8_plain
    out, ru = plain(*map(_t, (geno, iv, u, bq, sb, csum)), tile_d=tile_d, ranges=ranges)
    np.testing.assert_allclose((out - ru).numpy(), ref, rtol=1e-4, atol=1e-2)
    if len(ranges) > 1:
        one, _ = plain(*map(_t, (geno, iv, u, bq, sb, csum)), tile_d=tile_d)
        assert not torch.equal(out, one)


@pytest.mark.parametrize("ranges", [(1,), (0, 0), (0, 3, 2), (0, 4)])
def test_q8_pass_plain_refuses_ranges_out_of_order(rng, ranges):
    """`ranges` must be increasing first row tiles from 0 below the tile
    count (4 here)."""
    g, iv, u, bq, sb, csum = q8_case(rng, 256, 64, 16)
    args = map(_t, (pack_int8_rows(g), iv, u, bq, sb, csum))
    with pytest.raises(ValueError, match="ranges"):
        tk.fused_gram_q8_packed_plain(*args, tile_d=64, ranges=ranges)


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_q8_pass_cpu_wrappers_run_the_plain_pass(rng, layout):
    """On CPU tensors `fused_gram_q8_packed` / `fused_gram_q8` and the 2-D
    `q8_power_pass_2d` run the plain pass (tile order), count no launch and
    agree bit for bit."""
    g, iv, u, bq, sb, csum = q8_case(rng, 300, 256, 16, missing_rate=0.05)
    geno = pack_int8_rows(g) if layout == "packed" else g
    args = list(map(_t, (geno, iv, u, bq, sb, csum)))
    wrapper = tk.fused_gram_q8_packed if layout == "packed" else tk.fused_gram_q8
    tk.reset_launch_counts()
    out, ru = wrapper(*args, tile_d=64)
    out2, ru2 = tk.q8_power_pass_2d(*args, tile_d=64)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    out_p, ru_p = tk.fused_gram_q8_packed_plain(*args, tile_d=64)
    for a, b in ((out, out_p), (ru, ru_p), (out2, out_p), (ru2, ru_p)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("sms", [None, 132])
def test_q8_pass_plan_without_cuda_raises_as_q8_left2d_plan_does(monkeypatch, tmp_path,
                                                                  sms):
    """The plan is read from the built kernel library: without CUDA (no
    device for the SM count, no nvcc to build with) `q8_pass_plan` raises
    the error `q8_left2d_plan` raises, and reports no plan."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    errors = []
    for plan in (lambda: tk.q8_left2d_plan(262_144, 2_048, 128, 1024, sms),
                 lambda: tk.q8_pass_plan(262_144, 2_048, 128, 1024, sms)):
        with pytest.raises(Exception) as info:
            plan()
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_mma2d_ab_q8pass_checks_through_the_wrappers_and_needs_cuda(monkeypatch):
    """The A/B timer's q8 pass line holds kernels 1 and 9 to the plain pass
    through the wrappers before it times anything (on the CPU the wrapper
    runs the plain version, so it agrees at its check shapes), and the
    timer exits 1 without a CUDA device."""
    from genomic_pca_tpu_torch.eval import mma2d_ab

    cpu = torch.device("cpu")
    for layout in mma2d_ab.LAYOUTS:
        for shape in mma2d_ab.CHECKS["q8pass"][:2]:
            assert mma2d_ab.agrees("q8pass", layout, *shape, cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mma2d_ab.main(["tag", "--lines", "q8pass"]) == 1

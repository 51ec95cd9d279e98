"""CUDA kernels of the port against their plain PyTorch versions.

Needs an NVIDIA GPU (marker `cuda`; every test skips without one).  The
file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up jax for the other files.)
"""

import numpy as np
import pytest
import torch

from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, pack_int8_rows
from tests.torch_cases import (
    abs_corr, balding_nichols, dense_case, exact_case, q8_case, quant_model,
)

# Kernel vs plain, both on the card.  f32: the same products summed in
# another order (split-K atomics) - f32 rounding of O(1) sums.  bf16: the
# same operands rounded at the same points, but W is rounded to bf16 after
# a sum taken in another order, so an entry can move by one bf16 ulp of W.
TOL = {
    "f32": (1e-4, 1e-4),
    "bf16": (1e-2, 1e-3),
}
ZERO = dict.fromkeys(tk.LAUNCHES, 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (torch.cuda.is_available() is False)")
    return torch.device("cuda")


def _on(device, *arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", [
    "fused_gram_apply_packed", "fused_right_apply_packed", "fused_tsq_packed",
])
def test_exact_kernel_matches_plain(cuda_device, name, precision):
    packed, mu, inv, b = _on(cuda_device, *exact_case(np.random.default_rng(1)))
    tk.reset_launch_counts()
    got = getattr(tk, name)(packed, mu, inv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == 1
    ref = tk.PLAIN[name](packed, mu, inv, b, precision)
    rtol, atol = TOL[precision]
    if name == "fused_tsq_packed" and precision == "bf16":
        atol = 2e-2  # (L, L) entries with cancellation, as the reference test
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,tile_d", [(300, 250, 64), (2048, 512, 1024)])
def test_q8_kernel_matches_quant_model(cuda_device, d, n, tile_d):
    g, iv, u, bq, sb, csum = q8_case(np.random.default_rng(2), d, n, 128)
    n4 = -(-n // 4)
    bq_pad = np.zeros((4 * n4, 128), np.int8)
    bq_pad[:n] = bq
    args = _on(cuda_device, pack_int8_rows(g), iv, u, bq_pad, sb, csum)
    out, ru = tk.fused_gram_q8_packed(*args, tile_d=tile_d)
    t = (out - ru).cpu().numpy()[:n]
    ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    np.testing.assert_allclose(t, ref, rtol=1e-4, atol=1e-2)


@pytest.mark.cuda
def test_pca_core_on_cuda_matches_cpu(cuda_device):
    """The whole core on the card (kernels) vs on the CPU (plain
    versions), same bytes, same sketch: per-PC |r| > 0.9999."""
    rng = np.random.default_rng(3)
    g = balding_nichols(rng, 3000, 300, missing_rate=0.01, n_pops=6, fst=0.15)
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    mean = (g0.sum(1) / valid.sum(1)).astype(np.float32)
    std = np.ones_like(mean)
    b0 = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda_device):
        sm = ShardedMatrix.from_packed_rows(pack_int8_rows(g), mean, std, 300,
                                            device=dev, tile_d=1024)
        tk.reset_launch_counts()
        v, s, e, load = sm.pca_core(b0.to(dev), 4, 5)
        outs[str(dev)] = (v.cpu().numpy(), s.cpu().numpy(), load)
        if dev != "cpu":
            assert tk.LAUNCHES == dict(
                ZERO, fused_gram_q8_packed=3, fused_gram_apply_packed=1,
                fused_tsq_packed=1, fused_right_apply_packed=1)
    (vc, sc, lc), (vg, sg, lg) = outs["cpu"], outs["cuda"]
    np.testing.assert_allclose(sg, sc, rtol=1e-3)
    for j in range(5):
        assert abs_corr(vc[:, j], vg[:, j]) > 0.9999, j
        assert abs_corr(lc[:, j], lg[:, j]) > 0.9999, j


# ---------------------------------------------------------------------------
# The wide-sample (2-D) kernels.


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_wide_exact_kernel_matches_plain(cuda_device, precision):
    """Kernel 5: the same products as its plain version in another f32
    sum order."""
    name = "fused_right_apply_2d_packed"
    packed, mu, inv, b = _on(cuda_device, *exact_case(np.random.default_rng(4)))
    tk.reset_launch_counts()
    got = getattr(tk, name)(packed, mu, inv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == 1
    ref = tk.PLAIN[name](packed, mu, inv, b, precision)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)


def _mma_case(rng, layout, d, n):
    """Genotypes of the tensor-core products (packed bytes or dense int8)
    and their moments (d, 1): 5% missing, an inert row (inv_std 0), and in
    the dense layout some dosages outside {0, 1, 2}."""
    g = balding_nichols(rng, d, n, missing_rate=0.05)
    if layout == "dense":
        odd = rng.random(g.shape) < 0.02
        g[odd] = rng.integers(-100, 100, size=int(odd.sum()))
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    mu = (g0.sum(1) / np.maximum(valid.sum(1), 1)).astype(np.float32)[:, None]
    inv = (1.0 / (g0.std(1) + 0.1)).astype(np.float32)[:, None]
    inv[min(5, d - 1)] = 0.0
    return (pack_int8_rows(g) if layout == "packed" else g), mu, inv


def _launch_twice(name, args, precision):
    """Two launches of kernel `name`: (result, the plain version's), the
    launch count and the second launch's bits checked."""
    tk.reset_launch_counts()
    got = getattr(tk, name)(*args, precision=precision)
    again = getattr(tk, name)(*args, precision=precision)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == dict(ZERO, **{name: 2})
    assert torch.equal(got, again)
    return got, tk.PLAIN[name](*args, precision)


@pytest.mark.cuda
@pytest.mark.parametrize("d", [40, 1000, 2100])
@pytest.mark.parametrize("ell", [4, 10, 128, 130, 256])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_left_2d_kernel_matches_plain_and_repeats(cuda_device, layout,
                                                  precision, ell, d):
    """Kernels 6 (packed) and 14 (dense) against their plain versions on
    the card, to 1e-5 of max|plain| (the same bf16 operands, f32 sums in
    another order), and two launches bit for bit (no atomics, a fixed sum
    order).  D below one 64-row chunk, ragged past it, and past a 1,024-row
    fold; 250 packed samples (63-byte rows: the wrapper pads a copy to
    16-byte rows) and 252 dense ones (a partial 128-sample tile); L below,
    at and past the 128-column tile.  5% missing, an inert row, and in the
    dense layout some dosages outside {0, 1, 2}."""
    rng = np.random.default_rng(1000 * d + ell)
    n = 250 if layout == "packed" else 252
    geno, mu, inv = _mma_case(rng, layout, d, n)
    w = (3.0 * rng.standard_normal((d, ell))).astype(np.float32)
    name = ("fused_left_apply_2d_packed" if layout == "packed"
            else "fused_left_apply_2d")
    got, ref = _launch_twice(name, _on(cuda_device, geno, mu, inv, w), precision)
    assert got.shape == ref.shape == (4 * -(-n // 4), ell)
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(40, None), (300, None), (300, 2100)])
@pytest.mark.parametrize("ell", [4, 10, 128, 130, 256])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_2d_kernel_matches_plain_and_repeats(cuda_device, layout,
                                                   precision, ell, d, n):
    """Kernels 5 (packed) and 13 (dense) against their plain versions on
    the card, to 1e-5 of max|plain|, and two launches bit for bit (no
    atomics: the sample split's partials are added in a fixed order).  D
    below one 128-row tile and ragged past it; 250 packed samples (63-byte
    rows, a padded copy) and 252 dense ones (a partial 128-sample chunk);
    2,100 samples, past a 1,024-sample fold, on a strip of 300 rows whose
    3-6 blocks take the sample split (2 ranges); L below, at and past the
    128-column tile.  5% missing, an inert row, odd dense dosages."""
    rng = np.random.default_rng(7000 + 10 * d + ell)
    n = n or (250 if layout == "packed" else 252)
    geno, mu, inv = _mma_case(rng, layout, d, n)
    b = (rng.standard_normal((4 * -(-n // 4), ell)) / np.sqrt(n)).astype(np.float32)
    name = ("fused_right_apply_2d_packed" if layout == "packed"
            else "fused_right_apply_2d")
    if precision == "bf16" and n > 1024:
        assert tk.right2d_plan(d, b.shape[0], ell)[2] == 2
    got, ref = _launch_twice(name, _on(cuda_device, geno, mu, inv, b), precision)
    assert got.shape == ref.shape == (d, ell)
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err


@pytest.mark.cuda
def test_right_2d_plan(cuda_device):
    """The tile, grid and sample splits the library launches kernels 5 and
    13 with on 132 SMs: 128 rows x 128 columns a block; at 65,536 x 16,384
    its 512 blocks fill the card and the samples stay whole; a strip of
    2,000 (EigenSNP's) or 2,048 rows gives 16 blocks, so the samples split
    into 8 ranges (16 or 11 chunks of 128 each); a range is never shorter
    than a 1,024-sample fold, so narrow matrices do not split."""
    assert tk.right2d_plan(65_536, 16_384, 128, 132) == ((128, 128), (512, 1), 1)
    assert tk.right2d_plan(2_000, 16_384, 128, 132) == ((128, 128), (16, 1), 8)
    assert tk.right2d_plan(2_048, 11_264, 128, 132) == ((128, 128), (16, 1), 8)
    assert tk.right2d_plan(2_000, 16_384, 10, 132) == ((128, 128), (16, 1), 8)
    assert tk.right2d_plan(300, 2_100, 130, 132) == ((128, 128), (3, 2), 2)
    assert tk.right2d_plan(300, 1_000, 128, 132) == ((128, 128), (3, 1), 1)


@pytest.mark.cuda
def test_left_2d_plan_is_one_block_per_output_tile(cuda_device):
    """The tile and grid the library launches kernels 6 and 14 with: 128
    samples x 128 columns a block, every row in each block (no split of
    the rows).  16,384 samples give 128 blocks for 132 SMs, the 2-D switch
    width 11,264 (a streamed strip) 88; ragged widths round up."""
    assert tk.left2d_plan(16_384, 128) == ((128, 128), (128, 1))
    assert tk.left2d_plan(11_264, 128) == ((128, 128), (88, 1))
    assert tk.left2d_plan(250, 130) == ((128, 128), (2, 2))
    assert tk.left2d_plan(256, 4) == ((128, 128), (2, 1))


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,tile_d", [(300, 250, 64), (2048, 512, 1024)])
def test_wide_q8_kernels_match_plain_and_quant_model(cuda_device, d, n, tile_d):
    """Kernel 7 bit for bit (exact integer sums); kernel 8 to 1e-5 (f32
    sum order over tiles); the whole pass against the plain pass on the
    card (the same glue, so the same z8: 1e-5) and against the float64
    replay of the quantization model.  Against the replay a z that sits
    at an 8-bit rounding boundary in f32 can round the other way in
    float64 (on the card: 3 of 65,536 entries off by 1.03e-4 relative at
    2,048 x 512), so that bar is 1e-3 of max|T|, as in chip_smoke."""
    g, iv, u, bq, sb, csum = q8_case(np.random.default_rng(5), d, n, 128)
    n4 = -(-n // 4)
    bq_pad = np.zeros((4 * n4, 128), np.int8)
    bq_pad[:n] = bq
    args = _on(cuda_device, pack_int8_rows(g), iv, u, bq_pad, sb, csum)
    packed, bq_t = args[0], args[3]
    tk.reset_launch_counts()
    w = tk.right_apply_2d_q8(packed, bq_t)
    assert torch.equal(w, tk.right_apply_2d_q8_plain(packed, bq_t))
    z8 = torch.randint(-127, 128, (d, 128), dtype=torch.int8, device=cuda_device)
    sz = torch.rand(-(-d // tile_d), device=cuda_device) + 0.01
    got = tk.left_apply_2d_q8(packed, z8, sz, tile_d)
    ref = tk.left_apply_2d_q8_plain(packed, z8, sz, tile_d)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    out, ru = tk.q8_power_pass_2d(*args, tile_d=tile_d)
    assert tk.LAUNCHES["right_apply_2d_q8"] == 2
    assert tk.LAUNCHES["left_apply_2d_q8"] == 2
    t = (out - ru).cpu().numpy()[:n]
    out_p, ru_p = tk.fused_gram_q8_packed_plain(*args, tile_d=tile_d)
    t_p = (out_p - ru_p).cpu().numpy()[:n]
    np.testing.assert_allclose(t, t_p, rtol=1e-5, atol=1e-5 * np.abs(t_p).max())
    t_ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    assert np.abs(t - t_ref).max() <= 1e-3 * np.abs(t_ref).max()


@pytest.mark.cuda
def test_pca_core_2d_on_cuda_matches_cpu(cuda_device):
    """The 2-D mode's core on the card against the CPU: kernels 5-8 ran
    and 1-4 did not."""
    rng = np.random.default_rng(6)
    g = balding_nichols(rng, 3000, 300, missing_rate=0.01, n_pops=6, fst=0.15)
    valid = g != -127
    mean = (np.where(valid, g, 0).sum(1) / valid.sum(1)).astype(np.float32)
    std = np.ones_like(mean)
    b0 = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda_device):
        sm = ShardedMatrix.from_packed_rows(pack_int8_rows(g), mean, std, 300,
                                            device=dev, tile_d=1024, mode="2d")
        tk.reset_launch_counts()
        v, s, e, load = sm.pca_core(b0.to(dev), 4, 5)
        outs[str(dev)] = (v.cpu().numpy(), s.cpu().numpy(), load)
        if dev != "cpu":
            assert tk.LAUNCHES == dict(
                ZERO, fused_right_apply_2d_packed=3, fused_left_apply_2d_packed=1,
                right_apply_2d_q8=3, left_apply_2d_q8=3)
    (vc, sc, lc), (vg, sg, lg) = outs["cpu"], outs["cuda"]
    np.testing.assert_allclose(sg, sc, rtol=1e-3)
    for j in range(5):
        assert abs_corr(vc[:, j], vg[:, j]) > 0.9999, j
        assert abs_corr(lc[:, j], lg[:, j]) > 0.9999, j


# ---------------------------------------------------------------------------
# The dense int8 kernels of the 1-D mode.


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", [
    "fused_gram_apply", "fused_right_apply", "fused_tsq",
])
def test_dense_exact_kernel_matches_plain(cuda_device, name, precision):
    """5% missing (-127) and an inert row; 512 SNPs x 256 samples.  In
    bf16 a W entry whose f32 sum lands on a rounding boundary rounds one
    bf16 ulp the other way and moves the gram entries of its row by
    |x| * 2^-8 |W|: on an H100 2 of 32,768 entries by 5.8e-3, so gram and
    tsq take the reference test's tsq bar."""
    geno, mu, inv, b = _on(cuda_device, *dense_case(np.random.default_rng(7)))
    tk.reset_launch_counts()
    got = getattr(tk, name)(geno, mu, inv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == dict(ZERO, **{name: 1})
    ref = tk.PLAIN[name](geno, mu, inv, b, precision)
    rtol, atol = TOL[precision]
    if name != "fused_right_apply" and precision == "bf16":
        atol = 2e-2
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=rtol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,tile_d", [(300, 252, 64), (2048, 512, 1024)])
def test_dense_q8_kernel_matches_plain_and_quant_model(cuda_device, d, n, tile_d):
    """5% missing: the sentinel enters the integer products as raw 0.
    Against the plain pass on the card (same integers, f32 sums in another
    order) and the float64 replay (a z at an 8-bit rounding boundary can
    round the other way: 1e-3 of max|T|, as for the 2-D pass)."""
    g, iv, u, bq, sb, csum = q8_case(np.random.default_rng(8), d, n, 128,
                                     missing_rate=0.05)
    args = _on(cuda_device, g, iv, u, bq, sb, csum)
    tk.reset_launch_counts()
    out, ru = tk.fused_gram_q8(*args, tile_d=tile_d)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == dict(ZERO, fused_gram_q8=1)
    t = (out - ru).cpu().numpy()
    out_p, ru_p = tk.fused_gram_q8_plain(*args, tile_d=tile_d)
    t_p = (out_p - ru_p).cpu().numpy()
    np.testing.assert_allclose(t, t_p, rtol=1e-5, atol=1e-5 * np.abs(t_p).max())
    t_ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    assert np.abs(t - t_ref).max() <= 1e-3 * np.abs(t_ref).max()


@pytest.mark.cuda
def test_dense_kernels_refuse_a_ragged_width(cuda_device):
    geno, mu, inv, b = _on(cuda_device, *dense_case(np.random.default_rng(9),
                                                    d=64, n=30, ell=8))
    with pytest.raises(ValueError, match="multiple of 4"):
        tk.fused_right_apply(geno, mu, inv, b)


@pytest.mark.cuda
def test_pca_core_dense_on_cuda_matches_cpu(cuda_device):
    """The dense container's core on the card (kernels 9-12) against the
    CPU (plain versions), same bytes, same sketch; 300 samples pad to
    384 columns of -127."""
    rng = np.random.default_rng(10)
    g = balding_nichols(rng, 3000, 300, missing_rate=0.01, n_pops=6, fst=0.15)
    valid = g != -127
    mean = (np.where(valid, g, 0).sum(1) / valid.sum(1)).astype(np.float32)
    std = np.ones_like(mean)
    b0 = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda_device):
        sm = ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                       device=dev)
        tk.reset_launch_counts()
        v, s, e, load = sm.pca_core(b0.to(dev), 4, 5)
        outs[str(dev)] = (v.cpu().numpy(), s.cpu().numpy(), load)
        if dev != "cpu":
            assert tk.LAUNCHES == dict(ZERO, fused_gram_q8=3, fused_gram_apply=1,
                                       fused_tsq=1, fused_right_apply=1)
    (vc, sc, lc), (vg, sg, lg) = outs["cpu"], outs["cuda"]
    np.testing.assert_allclose(sg, sc, rtol=1e-3)
    for j in range(5):
        assert abs_corr(vc[:, j], vg[:, j]) > 0.9999, j
        assert abs_corr(lc[:, j], lg[:, j]) > 0.9999, j


# ---------------------------------------------------------------------------
# The dense 2-D kernels 13, 14, 7i and 8i.


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_dense_2d_exact_kernel_matches_plain(cuda_device, precision):
    """Kernel 13 on 5%-missing int8 with an inert row: the same products
    in another f32 sum order, W unrounded as in the plain version: the bar
    of kernel 5.  Kernel 14 is held with kernel 6 above."""
    name = "fused_right_apply_2d"
    geno, mu, inv, b = _on(cuda_device, *dense_case(np.random.default_rng(11)))
    tk.reset_launch_counts()
    got = getattr(tk, name)(geno, mu, inv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == dict(ZERO, **{name: 1})
    ref = tk.PLAIN[name](geno, mu, inv, b, precision)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * float(ref.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,tile_d", [(300, 252, 64), (2048, 512, 1024)])
def test_dense_2d_q8_kernels_match_plain_and_quant_model(cuda_device, d, n, tile_d):
    """Kernel 7i bit for bit (exact integer sums, the sentinel as raw 0),
    8i to 1e-5 (f32 sum order over tiles), the whole dense 2-D pass
    against the plain pass and the float64 replay (1e-3 of max|T|, as the
    packed 2-D pass); each branch counts under its own key."""
    g, iv, u, bq, sb, csum = q8_case(np.random.default_rng(12), d, n, 128,
                                     missing_rate=0.05)
    args = _on(cuda_device, g, iv, u, bq, sb, csum)
    geno, bq_t = args[0], args[3]
    tk.reset_launch_counts()
    w = tk.right_apply_2d_q8(geno, bq_t)
    assert torch.equal(w, tk.right_apply_2d_q8_plain(geno, bq_t))
    z8 = torch.randint(-127, 128, (d, 128), dtype=torch.int8, device=cuda_device)
    sz = torch.rand(-(-d // tile_d), device=cuda_device) + 0.01
    got = tk.left_apply_2d_q8(geno, z8, sz, tile_d)
    ref = tk.left_apply_2d_q8_plain(geno, z8, sz, tile_d)
    np.testing.assert_allclose(got.cpu().numpy(), ref.cpu().numpy(),
                               rtol=1e-5, atol=1e-5 * float(ref.abs().max()))
    out, ru = tk.q8_power_pass_2d(*args, tile_d=tile_d)
    assert tk.LAUNCHES == dict(ZERO, right_apply_2d_q8_i8=2, left_apply_2d_q8_i8=2)
    t = (out - ru).cpu().numpy()
    out_p, ru_p = tk.fused_gram_q8_plain(*args, tile_d=tile_d)
    t_p = (out_p - ru_p).cpu().numpy()
    np.testing.assert_allclose(t, t_p, rtol=1e-5, atol=1e-5 * np.abs(t_p).max())
    t_ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    assert np.abs(t - t_ref).max() <= 1e-3 * np.abs(t_ref).max()


@pytest.mark.cuda
def test_pca_core_dense_2d_on_cuda_matches_cpu(cuda_device):
    """The dense container's 2-D core on the card (13, 14, 7i, 8i and no
    other kernel) against the CPU (plain versions)."""
    rng = np.random.default_rng(13)
    g = balding_nichols(rng, 3000, 300, missing_rate=0.01, n_pops=6, fst=0.15)
    valid = g != -127
    mean = (np.where(valid, g, 0).sum(1) / valid.sum(1)).astype(np.float32)
    std = np.ones_like(mean)
    b0 = torch.from_numpy(rng.standard_normal((300, 64)).astype(np.float32))
    outs = {}
    for dev in ("cpu", cuda_device):
        sm = ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                       device=dev, mode="2d")
        tk.reset_launch_counts()
        v, s, e, load = sm.pca_core(b0.to(dev), 4, 5)
        outs[str(dev)] = (v.cpu().numpy(), s.cpu().numpy(), load)
        if dev != "cpu":
            assert tk.LAUNCHES == dict(
                ZERO, fused_right_apply_2d=3, fused_left_apply_2d=1,
                right_apply_2d_q8_i8=3, left_apply_2d_q8_i8=3)
    (vc, sc, lc), (vg, sg, lg) = outs["cpu"], outs["cuda"]
    np.testing.assert_allclose(sg, sc, rtol=1e-3)
    for j in range(5):
        assert abs_corr(vc[:, j], vg[:, j]) > 0.9999, j
        assert abs_corr(lc[:, j], lg[:, j]) > 0.9999, j


# ---------------------------------------------------------------------------
# The host-streamed container: pinned staging, a copy stream, events.


@pytest.mark.cuda
@pytest.mark.parametrize("packed", [True, False])
@pytest.mark.parametrize("mode", ["1d", "2d"])
def test_streaming_on_cuda_matches_cpu(cuda_device, packed, mode):
    """Five strips (a ragged last one) through the two staging slots:
    every pass on the card against the CPU run of the same strips, and
    the upload telemetry of each pass."""
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix
    from genomic_pca_tpu_torch.parallel.sharded import host_moments

    rng = np.random.default_rng(14)
    g = balding_nichols(rng, 600, 300, missing_rate=0.02, n_pops=5, fst=0.15)
    mean, std = host_moments(g)

    def source(i):
        lo, hi = 128 * i, min(128 * (i + 1), 600)
        rows = pack_int8_rows(g[lo:hi]) if packed else g[lo:hi]
        return rows, mean[lo:hi], std[lo:hi]

    b = torch.from_numpy(rng.standard_normal((300, 16)).astype(np.float32))
    got = {}
    for dev in ("cpu", cuda_device):
        sm = StreamingMatrix(source, 5, 600, 300, 128, mode=mode, packed=packed,
                             kernel_precision="f32", device=dev)
        got[str(dev)] = (sm.gram_apply(b.to(dev)).cpu().numpy(),
                         sm.tsq_accumulate(b.to(dev)).cpu().numpy(),
                         sm.right_apply(b.to(dev)))
        if dev != "cpu":
            for tel in sm.pass_log:
                assert tel["strips"] == 5 and tel["bytes"] > 0
                assert tel["copy_seconds"] > 0 and tel["compute_wait_seconds"] >= 0
    for a, c in zip(got["cpu"], got["cuda"]):
        np.testing.assert_allclose(c, a, rtol=1e-4, atol=1e-4 * np.abs(a).max())

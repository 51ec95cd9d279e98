"""CUDA kernels of the port against their plain PyTorch versions.

Needs an NVIDIA GPU (marker `cuda`; every test skips without one).  The
file imports no jax, so it also runs where jax is not installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(`--noconftest` because tests/conftest.py sets up jax for the other files.)
"""

import numpy as np
import pytest
import torch

from genomic_pca_tpu_torch.models.pca import pca_core
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


# The C entries one tsq call makes: in bf16 mode the one tensor-core call,
# in f32 mode the FMA right loop and W^T W split-K.
TSQ_ENTRIES = {
    "packed": {"bf16": ["gp_tsq_packed"], "f32": ["gp_right_packed", "gp_wtw"]},
    "dense": {"bf16": ["gp_tsq_dense"], "f32": ["gp_right_dense", "gp_wtw"]},
}


def _spy_entries(monkeypatch) -> list:
    """The names of the C entries `kernels._launch` calls from now on."""
    seen, real = [], tk._launch

    def spy(device, entry, *args):
        seen.append(entry)
        real(device, entry, *args)

    monkeypatch.setattr(tk, "_launch", spy)
    return seen


@pytest.mark.cuda
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", [
    "fused_gram_apply_packed", "fused_right_apply_packed", "fused_tsq_packed",
])
def test_exact_kernel_matches_plain(cuda_device, monkeypatch, name, precision):
    """Kernels 2-4 against their plain versions; the tsq pass makes one C
    call in bf16 mode and keeps the FMA pair (gp_wtw) in f32 mode."""
    packed, mu, inv, b = _on(cuda_device, *exact_case(np.random.default_rng(1)))
    entries = _spy_entries(monkeypatch)
    tk.reset_launch_counts()
    got = getattr(tk, name)(packed, mu, inv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.LAUNCHES[name] == 1
    if name == "fused_tsq_packed":
        assert entries == TSQ_ENTRIES["packed"][precision]
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
        v, s, e, load, _ = pca_core(sm, b0.to(dev), 4, 5)
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
    """The tile, grid and row ranges the library launches kernels 6 and 14
    with on 132 SMs: 128 samples x 128 columns a block, every row in each
    block (one range) at the 2-D widths: 16,384 samples give 128 blocks,
    the 2-D switch width 11,264 (a streamed strip) 88; ragged widths round
    up, and rows within one fold never split."""
    assert tk.left2d_plan(65_536, 16_384, 128, 132) == ((128, 128), (128, 1), 1)
    assert tk.left2d_plan(2_000, 16_384, 128, 132) == ((128, 128), (128, 1), 1)
    assert tk.left2d_plan(65_536, 11_264, 128, 132) == ((128, 128), (88, 1), 1)
    assert tk.left2d_plan(1_024, 250, 130, 132) == ((128, 128), (2, 2), 1)
    assert tk.left2d_plan(40, 256, 4, 132) == ((128, 128), (2, 1), 1)


@pytest.mark.cuda
def test_gram_1d_plan_splits_rows_and_samples(cuda_device):
    """The plans of the bf16 gram pass (kernels 2 and 10) on 132 SMs.  At
    the 1-D main shape 262,144 x 2,048, L = 128, the right product fills
    the card with 2,048 row blocks and keeps the samples whole, and the
    left product's 16 sample tiles take 8 row ranges of 32 folds (128
    blocks); the workspace is W in bf16 and the 8 row slabs.  A streamed
    strip of 2,048 x 2,048 splits both: 2 sample ranges, 2 row ranges,
    their slabs sharing the bytes after W.  Narrow or short matrices split
    only as far as they have folds."""
    assert tk.left2d_plan(262_144, 2_048, 128, 132) == ((128, 128), (16, 1), 8)
    right, left, work = tk.gram_plan(262_144, 512, 2_048, 128, 132)
    assert right == ((128, 128), (2_048, 1), 1)
    assert left == ((128, 128), (16, 1), 8)
    assert work == 262_144 * 128 * 2 + 8 * 2_048 * 128 * 4
    right, left, work = tk.gram_plan(2_048, 512, 2_048, 128, 132)
    assert right == ((128, 128), (16, 1), 2)
    assert left == ((128, 128), (16, 1), 2)
    assert work == 2_048 * 128 * 2 + 2 * 2_048 * 128 * 4
    right, left, work = tk.gram_plan(5_000, 128, 512, 130, 132)
    assert right == ((128, 128), (40, 2), 1)
    assert left == ((128, 128), (4, 2), 5)
    assert work == -(-5_000 * 136 * 2 // 256) * 256 + 5 * 512 * 130 * 4
    assert tk.gram_plan(1_000, 64, 256, 10, 132)[1][2] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(2100, None), (5000, 512), (2048, 2048)])
@pytest.mark.parametrize("ell", [10, 130])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_gram_1d_kernel_matches_plain_and_repeats(cuda_device, layout, ell, d, n):
    """Kernels 2 (packed) and 10 (dense) in bf16 mode: the one-call gram
    pass on the tensor cores.  Two launches bit for bit (no atomics); the
    right half's f32 W (kernel 5 / 13: the same kernel and plan) within
    1e-5 of the plain right product; the pass within 1e-5 of max|ref| of
    the plain left product of that W rounded to bf16 (so W is rounded once
    and its pad is inert); and within 1e-5 of max|plain| of the plain gram
    plus, entry by entry, |A|^T |dW|, dW the bf16 W entries that round one
    ulp apart from the plain W's (ties: the f32 sums run in another
    order).  Ragged D past a fold with 250 packed / 252 dense samples (the
    rows split into 3 ranges), 5,000 x 512 (5 row ranges), and a streamed
    1-D strip of 2,048 x 2,048 (2 sample ranges, 2 row ranges); L = 10 and
    130 (a padded W); 5% missing, an inert row, odd dense dosages."""
    from genomic_pca_tpu_torch.eval.mma2d_ab import gram_reference

    rng = np.random.default_rng(9000 + d + ell)
    n = n or (250 if layout == "packed" else 252)
    geno, mu, inv = _mma_case(rng, layout, d, n)
    b = (rng.standard_normal((4 * -(-n // 4), ell)) / np.sqrt(n)).astype(np.float32)
    name = "fused_gram_apply_packed" if layout == "packed" else "fused_gram_apply"
    args = _on(cuda_device, geno, mu, inv, b)
    groups = tk._samples(tk.aligned_rows(args[0])) // 4
    right, left, _ = tk.gram_plan(d, groups, b.shape[0], ell)
    assert (right[2], left[2]) == {2100: (1, 3), 5000: (1, 5), 2048: (2, 2)}[d]
    got, plain = _launch_twice(name, args, "bf16")
    assert got.shape == plain.shape == (b.shape[0], ell)
    ref, w_err, ties = gram_reference(*args)
    assert w_err <= 1e-5, w_err
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    allow = tk.standardize(*args[:3]).abs().T @ ties.abs()
    assert bool(((got - plain).abs() <= 1e-5 * float(plain.abs().max()) + allow).all())


@pytest.mark.cuda
def test_tsq_1d_plan_splits_rows(cuda_device):
    """The plans of the bf16 tsq pass (kernels 3 and 12) on 132 SMs: its
    right product is the gram pass's (the same W), and W^T W takes one
    128 x 128 tile at L <= 128 (2 x 2 at L = 130) and splits the rows into
    min(SMs / tiles, folds) ranges of whole 1,024-row folds: 128 ranges of
    2 folds at the 1-D main shape 262,144 x 2,048, L = 128.  The
    workspace is W in bf16, then the larger slab: the right product's
    sample ranges or W^T W's row ranges."""
    right, wtw, work = tk.tsq_plan(262_144, 512, 2_048, 128, 132)
    assert right == tk.gram_plan(262_144, 512, 2_048, 128, 132)[0]
    assert right == ((128, 128), (2_048, 1), 1)
    assert wtw == ((128, 128), (1, 1), 128)
    assert work == 262_144 * 128 * 2 + 128 * 128 * 128 * 4
    right, wtw, work = tk.tsq_plan(2_048, 512, 2_048, 128, 132)
    assert right == ((128, 128), (16, 1), 2)
    assert wtw == ((128, 128), (1, 1), 2)
    assert work == 2_048 * 128 * 2 + max(2 * 2_048 * 128, 2 * 128 * 128) * 4
    right, wtw, work = tk.tsq_plan(5_000, 128, 512, 130, 132)
    assert right == ((128, 128), (40, 2), 1)
    assert wtw == ((128, 128), (2, 2), 5)
    assert work == -(-5_000 * 136 * 2 // 256) * 256 + 5 * 130 * 130 * 4
    assert tk.tsq_plan(1_000, 64, 256, 10, 132)[1] == ((128, 128), (1, 1), 1)
    assert tk.tsq_plan(1_000, 64, 256, 10, 132)[2] == -(-1_000 * 16 * 2 // 256) * 256


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(2100, None), (5000, 512), (2048, 2048)])
@pytest.mark.parametrize("ell", [10, 130])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_tsq_1d_kernel_matches_plain_and_repeats(cuda_device, monkeypatch, layout,
                                                 ell, d, n):
    """Kernels 3 (packed) and 12 (dense) in bf16 mode: one C call, the gram
    pass's W store then W^T W on the tensor cores.  Two launches bit for
    bit (no atomics); the right half's f32 W (kernel 5 / 13: the same
    kernel and plan) within 1e-5 of the plain right product; the W^T W
    half within 1e-5 of max|G| of a float64 W^T W over that W rounded to
    bf16 (so W is rounded once and its pad is inert); and the pass within
    1e-5 of max|plain| of the plain tsq plus, entry by entry, |dW|^T |W| +
    |W|^T |dW|, dW the bf16 W entries that round one ulp apart from the
    plain W's (ties: the f32 sums run in another order).  Ragged D past a
    fold with 250 packed / 252 dense samples (W^T W's rows in 3 ranges),
    5,000 x 512 (5 ranges), and a streamed 1-D strip of 2,048 x 2,048 (2
    sample ranges, 2 row ranges); L = 10 and 130 (a padded W, 2 x 2 output
    tiles); 5% missing, an inert row, odd dense dosages."""
    from genomic_pca_tpu_torch.eval.mma2d_ab import tsq_reference

    rng = np.random.default_rng(9500 + d + ell)
    n = n or (250 if layout == "packed" else 252)
    geno, mu, inv = _mma_case(rng, layout, d, n)
    b = (rng.standard_normal((4 * -(-n // 4), ell)) / np.sqrt(n)).astype(np.float32)
    name = "fused_tsq_packed" if layout == "packed" else "fused_tsq"
    args = _on(cuda_device, geno, mu, inv, b)
    groups = tk._samples(tk.aligned_rows(args[0])) // 4
    right, wtw, _ = tk.tsq_plan(d, groups, b.shape[0], ell)
    assert (right[2], wtw[2]) == {2100: (1, 3), 5000: (1, 5), 2048: (2, 2)}[d]
    assert wtw[1] == ((1, 1) if ell <= 128 else (2, 2))
    entries = _spy_entries(monkeypatch)
    got, plain = _launch_twice(name, args, "bf16")
    assert entries == TSQ_ENTRIES[layout]["bf16"] * 2
    assert got.shape == plain.shape == (ell, ell)
    ref, w_err, ties, allow = tsq_reference(*args)
    assert w_err <= 1e-5, w_err
    assert float((got.double() - ref).abs().max()) <= 1e-5 * float(ref.abs().max())
    assert bool(((got - plain).abs().double()
                 <= 1e-5 * float(plain.abs().max()) + allow).all())


@pytest.mark.cuda
@pytest.mark.parametrize("d,n,tile_d", [(300, 250, 64), (2048, 512, 1024)])
def test_wide_q8_kernels_match_plain_and_quant_model(cuda_device, d, n, tile_d):
    """Kernels 7 and 8 bit for bit (exact integer sums; 8 folds its tiles
    in order, as its plain version at the plan's row ranges); the whole
    pass against the plain pass on the
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
    assert torch.equal(got, _q8_left_plain(packed, z8, sz, tile_d))
    out, ru = tk.q8_power_pass_2d(*args, tile_d=tile_d)
    assert tk.LAUNCHES["right_apply_2d_q8"] == 2
    assert tk.LAUNCHES["left_apply_2d_q8"] == 2
    t = (out - ru).cpu().numpy()[:n]
    out_p, ru_p = tk.fused_gram_q8_packed_plain(*args, tile_d=tile_d)
    t_p = (out_p - ru_p).cpu().numpy()[:n]
    np.testing.assert_allclose(t, t_p, rtol=1e-5, atol=1e-5 * np.abs(t_p).max())
    t_ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    assert np.abs(t - t_ref).max() <= 1e-3 * np.abs(t_ref).max()
    assert torch.equal(tk.right_apply_2d_q8(packed, bq_t), w)


def _q8_right_case(rng, d, n, ell, layout):
    """Unstructured dosages {0, 1, 2} with 5% missing and row 7 all
    missing (a swapped pair of samples would show), packed or int8, and a
    random bq (N, L)."""
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -127
    g[min(7, d - 1)] = -127
    bq = rng.integers(-127, 128, size=(n, ell)).astype(np.int8)
    return (pack_int8_rows(g) if layout == "packed" else g), bq


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("d,n,ell", [
    (200, 1_100, 10), (200, 1_100, 130), (300, 2_100, 130),  # ragged
    (2_000, 16_384, 128),  # an EigenSNP strip: the samples split
    (2_048, 11_264, 128),  # a streamed strip at the 2-D switch width
])
def test_q8_right_2d_kernel_matches_plain_bit_for_bit(cuda_device, layout, d, n, ell):
    """Kernels 7 and 7i (s8 wgmma, int32 sums converted once) equal their
    plain versions bit for bit, at rows and samples that are not whole
    tiles or chunks (TMA's zero fill decodes to dosage 2 packed: those rows
    must not be stored, those samples must meet zero columns of bq^T) and
    at the thin strips whose samples split into int32 slabs; a second
    launch repeats the bits; each branch counts under its own key."""
    geno, bq = _on(cuda_device, *_q8_right_case(np.random.default_rng(15), d, n, ell,
                                                layout))
    tk.reset_launch_counts()
    got, again = tk.right_apply_2d_q8(geno, bq), tk.right_apply_2d_q8(geno, bq)
    torch.cuda.synchronize()
    name = "right_apply_2d_q8" if layout == "packed" else "right_apply_2d_q8_i8"
    assert tk.LAUNCHES == dict(ZERO, **{name: 2})
    assert torch.equal(got, tk.right_apply_2d_q8_plain(geno, bq))
    assert torch.equal(got, again)
    assert not bool(got[7].any())


@pytest.mark.cuda
def test_q8_right_2d_plan(cuda_device):
    """The q8 right product's tile, grid and sample splits as the library
    reports them: one range at the 2-D kernel shape, eight at the thin
    strips, and ranges of at least 1,024 samples."""
    assert tk.q8_right2d_plan(65_536, 16_384, 128, 132) == ((128, 128), (512, 1), 1)
    assert tk.q8_right2d_plan(2_000, 16_384, 128, 132) == ((128, 128), (16, 1), 8)
    assert tk.q8_right2d_plan(2_048, 11_264, 128, 132) == ((128, 128), (16, 1), 8)
    assert tk.q8_right2d_plan(200, 1_152, 130, 132) == ((128, 128), (2, 2), 1)
    assert tk.q8_right2d_plan(5, 70_016, 16, 132) == ((128, 128), (1, 1), 55)
    assert tk.q8_right2d_plan(5, 70_016, 16, 1) == ((128, 128), (1, 1), 1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_q8_right_2d_sums_past_2_24_are_exact_with_and_without_a_split(cuda_device,
                                                                      layout):
    """5 rows x 70,000 samples, dosage 2 and bq 127 but for a few entries:
    |sum| passes 2^24 and most sums are odd.  The kernel gives the int64
    product converted once both through the wrapper (the samples split into
    55 ranges on 132 SMs: the slab stays int32) and through the C entry
    planned for one SM (one range), as the plain version does."""
    rng = np.random.default_rng(24)
    d, n, ell = 5, 70_000, 16
    g = np.full((d, n), 2, np.int8)
    g[rng.random(g.shape) < 0.001] = 1
    g[rng.random(g.shape) < 0.001] = -127
    bq = np.full((n, ell), 127, np.int8)
    bq[rng.random(bq.shape) < 0.001] = -5
    exact = np.maximum(g, 0).astype(np.int64) @ bq.astype(np.int64)
    assert exact.min() >= 2**24 and (exact % 2).any()
    geno, b = _on(cuda_device, pack_int8_rows(g) if layout == "packed" else g, bq)
    rows = tk.aligned_rows(geno)
    samples = tk._samples(rows)
    assert tk.q8_right2d_plan(d, samples, ell)[2] > 1
    got = tk.right_apply_2d_q8(geno, b)
    one = torch.empty((d, ell), dtype=torch.float32, device=cuda_device)
    bqt = tk.q8_operand(b, samples)
    tk._launch(cuda_device, tk._ENTRY[geno.dtype]["q8_right2d"], rows, bqt, one, None,
               d, samples // 4, ell, bqt.shape[1], 1)
    np.testing.assert_array_equal(got.cpu().numpy(), exact.astype(np.float32))
    np.testing.assert_array_equal(one.cpu().numpy(), exact.astype(np.float32))
    assert torch.equal(got, tk.right_apply_2d_q8_plain(geno, b))


def _q8_left_plain(geno, z8, sz, tile_d):
    """The plain q8 left product at the row ranges the kernel's plan splits
    these rows into: the kernel's order, so its bits."""
    ranges = tk.q8_left2d_plan(geno.shape[0], tk._samples(tk.aligned_rows(geno)),
                               z8.shape[1], tile_d)[2]
    return tk.left_apply_2d_q8_plain(geno, z8, sz, tile_d, ranges)


def _q8_left_case(rng, d, n, ell, tile_d, layout):
    """Unstructured dosages {0, 1, 2} with 5% missing and row 7 all missing
    (the -127 sentinel dense), packed or int8, a random z8 (D, L) and
    per-tile scales."""
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -127
    g[min(7, d - 1)] = -127
    z8 = rng.integers(-127, 128, size=(d, ell)).astype(np.int8)
    sz = rng.uniform(0.01, 0.1, size=-(-d // tile_d)).astype(np.float32)
    return (pack_int8_rows(g) if layout == "packed" else g), z8, sz


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("d,n,ell,tile_d", [
    (200, 1_100, 10, 32), (300, 2_100, 130, 64),  # ragged rows and samples
    (2_000, 16_384, 128, 1024),  # an EigenSNP strip: a ragged last row tile
    (2_048, 11_264, 128, 1024), (2_048, 11_264, 128, 64),  # rows split in 2
    (4_100, 2_048, 128, 64),  # the 1-D width: rows split 8 ways, ragged
])
def test_q8_left_2d_kernel_matches_plain_bit_for_bit(cuda_device, layout, d, n, ell,
                                                    tile_d):
    """Kernels 8 and 8i (s8 wgmma, each row tile's int32 sum folded into
    f32 in tile order, ranges of whole tiles added in order) equal their
    plain versions at the plan's ranges bit for bit, at rows, samples and
    tiles that are not whole chunks (TMA's zero fill decodes to dosage 2
    packed: those rows must meet zero columns of z8^T, those samples must
    not be stored), at row tiles of 32, 64 and 1,024 and at split strips;
    a second launch repeats the bits; each branch counts under its own
    key."""
    geno, z8, sz = _on(cuda_device, *_q8_left_case(np.random.default_rng(16), d, n,
                                                   ell, tile_d, layout))
    tk.reset_launch_counts()
    got = tk.left_apply_2d_q8(geno, z8, sz, tile_d)
    again = tk.left_apply_2d_q8(geno, z8, sz, tile_d)
    torch.cuda.synchronize()
    name = "left_apply_2d_q8" if layout == "packed" else "left_apply_2d_q8_i8"
    assert tk.LAUNCHES == dict(ZERO, **{name: 2})
    assert got.shape == (n, ell)
    assert torch.equal(got, _q8_left_plain(geno, z8, sz, tile_d))
    assert torch.equal(got, again)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_q8_left_2d_refuses_a_tile_of_partial_k_steps(cuda_device, layout):
    """On the card the row tile must be whole K steps of 32 rows: 48 raises
    ValueError before any launch, with no fallback to the plain version."""
    geno, z8, sz = _on(cuda_device, *_q8_left_case(np.random.default_rng(17), 96, 256,
                                                   128, 48, layout))
    tk.reset_launch_counts()
    with pytest.raises(ValueError, match="multiple of 32"):
        tk.left_apply_2d_q8(geno, z8, sz, 48)
    assert tk.LAUNCHES == ZERO


@pytest.mark.cuda
def test_q8_left_2d_plan(cuda_device):
    """The q8 left product's tile, grid, row ranges (first row tile of
    each) and workspace bytes (z8^T, then the slab) as the library reports
    them: one range at the 2-D kernel shape and the EigenSNP strip, two at
    the streamed strip of the switch width, eight at the 1-D width."""
    assert tk.q8_left2d_plan(65_536, 16_384, 128, 1024, 132) == (
        (128, 128), (128, 1), (0,), 128 * 65_536)
    assert tk.q8_left2d_plan(131_072, 16_384, 128, 1024, 132)[1:3] == ((128, 1), (0,))
    assert tk.q8_left2d_plan(2_000, 16_384, 128, 1024, 132) == (
        (128, 128), (128, 1), (0,), 128 * 2_000)
    assert tk.q8_left2d_plan(2_048, 11_264, 128, 1024, 132) == (
        (128, 128), (88, 1), (0, 1), 128 * 2_048 + 4 * 2 * 11_264 * 128)
    assert tk.q8_left2d_plan(262_144, 2_048, 128, 1024, 132) == (
        (128, 128), (16, 1), tuple(range(0, 256, 32)),
        128 * 262_144 + 4 * 8 * 2_048 * 128)
    assert tk.q8_left2d_plan(2_048, 2_048, 128, 1024, 132)[2] == (0, 1)
    assert tk.q8_left2d_plan(300, 2_112, 130, 64, 132)[1:3] == ((17, 2), (0, 2, 4))
    assert tk.q8_left2d_plan(262_144, 2_048, 128, 1024, 1)[2] == (0,)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_q8_left_2d_builds_z8t_as_the_operand_states(cuda_device, layout):
    """The C call builds z8^T at the head of its workspace as
    `q8_left_operand` states it (zero pads), and the result is the
    wrapper's."""
    d, n, ell, tile_d = 300, 2_100, 130, 64
    geno, z8, sz = _on(cuda_device, *_q8_left_case(np.random.default_rng(18), d, n, ell,
                                                   tile_d, layout))
    rows = tk.aligned_rows(geno)
    samples = tk._samples(rows)
    work_bytes = tk.q8_left2d_plan(d, samples, ell, tile_d)[3]
    work = torch.full((work_bytes,), 0x5A, dtype=torch.uint8, device=cuda_device)
    out = torch.empty((samples, ell), dtype=torch.float32, device=cuda_device)
    tk._launch(cuda_device, tk._ENTRY[geno.dtype]["q8_left2d"], rows, z8, sz, out, work,
               d, samples // 4, ell, tile_d, tk._sms(cuda_device))
    op = tk.q8_left_operand(z8)
    assert torch.equal(work[: op.numel()].view(torch.int8).view(op.shape), op)
    assert torch.equal(out[:n], tk.left_apply_2d_q8(geno, z8, sz, tile_d))


# The one C call of a q8 pass (csrc/q8_pass.cuh), by layout.
Q8_PASS = {"packed": ("fused_gram_q8_packed", "gp_q8_pass_packed"),
           "dense": ("fused_gram_q8", "gp_q8_pass_dense")}


def _q8_pass_case(rng, d, n, layout, ell=128):
    """Inputs of a q8 pass on the card: unstructured dosages {0, 1, 2} with
    2% missing, packed or int8, moments and a quantized random basis (as
    the A/B script's check makes them)."""
    from genomic_pca_tpu_torch.eval.mma2d_ab import q8_pass_args

    g = rng.integers(0, 3, size=(d, n), dtype=np.int8)
    g[rng.random(g.shape) < 0.02] = -127
    return q8_pass_args(pack_int8_rows(g) if layout == "packed" else g,
                        torch.device("cuda"), rng, ell)


def _ru_allowance(args):
    """Entry by entry 1e-5 of sum |u y| over the rows: how far two f32 sums
    of u y in different orders may lie apart (ru's order is the card's own)."""
    geno, iv, u, bq, sb, csum = args
    y = iv * (tk.right_apply_2d_q8_plain(geno, bq) * sb) - u * csum
    return 1e-5 * (u * y).abs().sum(0, keepdim=True)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("d,n,tile_d", [
    (4_096, 2_048, 1024), (4_096, 2_048, 64),  # the 1-D width: rows split 8 ways
    (70_001, 2_504, 1024),  # rows not whole 16-byte units, a ragged last tile
    (2_048, 2_048, 1024),  # a streamed strip: the samples split, 2 row ranges
])
def test_q8_pass_matches_plain_bit_for_bit_and_repeats(cuda_device, monkeypatch, layout,
                                                       d, n, tile_d):
    """Kernels 1 and 9: one C call (kernel 7's s8 wgmma, the requantization
    into z8^T, kernel 8's s8 wgmma with its row split) whose `out` equals
    the plain pass at the plan's row ranges bit for bit, whose ru agrees
    with the plain sum to f32 rounding, and whose second launch repeats
    both bit for bit."""
    name, entry = Q8_PASS[layout]
    args = _q8_pass_case(np.random.default_rng(19), d, n, layout)
    entries = _spy_entries(monkeypatch)
    tk.reset_launch_counts()
    fn = getattr(tk, name)
    out, ru = fn(*args, tile_d=tile_d)
    out2, ru2 = fn(*args, tile_d=tile_d)
    torch.cuda.synchronize()
    assert entries == [entry, entry]
    assert tk.LAUNCHES == dict(ZERO, **{name: 2})
    assert out.shape == (n, 128) and ru.shape == (1, 128)
    ranges = tk.q8_pass_plan(d, tk._samples(tk.aligned_rows(args[0])), 128, tile_d)[1][2]
    out_p, ru_p = tk.PLAIN[name](*args, tile_d=tile_d, ranges=ranges)
    assert torch.equal(out, out_p)
    assert bool(((ru - ru_p).abs() <= _ru_allowance(args)).all())
    assert torch.equal(out, out2) and torch.equal(ru, ru2)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("d,n,tile_d", [(300, 2_100, 64), (2_048, 2_048, 1024)])
def test_q8_pass_builds_its_operands_as_the_plain_pass(cuda_device, layout, d, n,
                                                       tile_d):
    """The C call's workspace holds, from its head (each part from a
    256-byte boundary), bq^T as `q8_operand` states it, z8^T as
    `q8_left_operand` states it and sz: the requantization's z8 and sz
    equal `q8_requant_plain`'s on the plain W bit for bit, zero pads
    included (300 rows: a ragged last tile; 2,100 samples: rows copied to
    whole 16-byte units)."""
    args = _q8_pass_case(np.random.default_rng(21), d, n, layout)
    geno, iv, u, bq, sb, csum = args
    rows = tk.aligned_rows(geno)
    width = tk._samples(rows)
    work = torch.full((tk.q8_pass_plan(d, width, 128, tile_d)[2],), 0x5A,
                      dtype=torch.uint8, device=cuda_device)
    out = torch.empty((width, 128), device=cuda_device)
    ru = torch.empty((1, 128), device=cuda_device)
    tk._launch(cuda_device, tk._ENTRY[geno.dtype]["q8_pass"], rows, iv, u, bq, sb, csum,
               out, ru, work, d, width // 4, n, 128, tile_d, tk._sms(cuda_device))
    z8, sz, _ = tk.q8_requant_plain(tk.right_apply_2d_q8_plain(geno, bq), iv, u, sb,
                                    csum, tile_d)
    at = 0
    for want in (tk.q8_operand(bq, width), tk.q8_left_operand(z8), sz):
        nbytes = want.numel() * want.element_size()
        got = work[at:at + nbytes].view(want.dtype).view(want.shape)
        assert torch.equal(got, want)
        at += -(-nbytes // 256) * 256
    assert torch.equal(out[:n], getattr(tk, Q8_PASS[layout][0])(*args, tile_d=tile_d)[0])


@pytest.mark.cuda
def test_q8_pass_plan(cuda_device):
    """The pass's plans are its products' own plans (the right product's
    samples split on a strip; the left product's rows in 8 ranges at 2,048
    samples, 2 on a strip of 2,048 rows), and its workspace holds at least
    bq^T, z8^T and W."""
    for d, n in ((262_144, 2_048), (2_048, 2_048), (70_001, 2_560), (131_072, 16_384)):
        right, left, work = tk.q8_pass_plan(d, n, 128, 1024, 132)
        assert right == tk.q8_right2d_plan(d, n, 128, 132)
        assert left == tk.q8_left2d_plan(d, n, 128, 1024, 132)[:3]
        assert work >= 128 * n + 128 * d + 4 * d * 128
    assert tk.q8_pass_plan(262_144, 2_048, 128, 1024, 132)[:2] == (
        ((128, 128), (2_048, 1), 1), ((128, 128), (16, 1), tuple(range(0, 256, 32))))
    right, left, _ = tk.q8_pass_plan(2_048, 2_048, 128, 1024, 132)
    assert right[2] == 2 and left[2] == (0, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("d,n", [(2_048, 11_264), (3_000, 1_024)])
def test_q8_pass_2d_takes_the_pass_entry(cuda_device, monkeypatch, layout, d, n):
    """`q8_power_pass_2d` runs the same one C call, counted as one launch
    of each 2-D q8 product, and its `out` equals the composition of the 2-D
    products' own wrappers with the requantization in torch between them
    (kernel 7, `q8_requant_plain`, kernel 8) bit for bit."""
    args = _q8_pass_case(np.random.default_rng(20), d, n, layout)
    geno, iv, u, bq, sb, csum = args
    entries = _spy_entries(monkeypatch)
    tk.reset_launch_counts()
    out, ru = tk.q8_power_pass_2d(*args, tile_d=1024)
    torch.cuda.synchronize()
    assert entries == [Q8_PASS[layout][1]]
    names = tk._Q8_2D_NAME[geno.dtype]
    assert tk.LAUNCHES == dict(ZERO, **dict.fromkeys(names, 1))
    z8, sz, ru_c = tk.q8_requant_plain(tk.right_apply_2d_q8(geno, bq), iv, u, sb, csum,
                                       1024)
    assert torch.equal(out, tk.left_apply_2d_q8(geno, z8, sz, 1024))
    assert bool(((ru - ru_c).abs() <= _ru_allowance(args)).all())


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
        v, s, e, load, _ = pca_core(sm, b0.to(dev), 4, 5)
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
def test_dense_exact_kernel_matches_plain(cuda_device, monkeypatch, name, precision):
    """5% missing (-127) and an inert row; 512 SNPs x 256 samples.  In
    bf16 a W entry whose f32 sum lands on a rounding boundary rounds one
    bf16 ulp the other way and moves the gram entries of its row by
    |x| * 2^-8 |W|: on an H100 2 of 32,768 entries by 5.8e-3, so gram and
    tsq take the reference test's tsq bar.  The tsq pass makes one C call
    in bf16 mode and keeps the FMA pair (gp_wtw) in f32 mode."""
    geno, mu, inv, b = _on(cuda_device, *dense_case(np.random.default_rng(7)))
    entries = _spy_entries(monkeypatch)
    tk.reset_launch_counts()
    got = getattr(tk, name)(geno, mu, inv, b, precision=precision)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == dict(ZERO, **{name: 1})
    if name == "fused_tsq":
        assert entries == TSQ_ENTRIES["dense"][precision]
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
        v, s, e, load, _ = pca_core(sm, b0.to(dev), 4, 5)
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
    """Kernels 7i and 8i bit for bit (exact integer sums, the sentinel as
    raw 0; 8i at its plan's row ranges), the whole dense 2-D pass
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
    assert torch.equal(got, _q8_left_plain(geno, z8, sz, tile_d))
    out, ru = tk.q8_power_pass_2d(*args, tile_d=tile_d)
    assert tk.LAUNCHES == dict(ZERO, right_apply_2d_q8_i8=2, left_apply_2d_q8_i8=2)
    t = (out - ru).cpu().numpy()
    out_p, ru_p = tk.fused_gram_q8_plain(*args, tile_d=tile_d)
    t_p = (out_p - ru_p).cpu().numpy()
    np.testing.assert_allclose(t, t_p, rtol=1e-5, atol=1e-5 * np.abs(t_p).max())
    t_ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    assert np.abs(t - t_ref).max() <= 1e-3 * np.abs(t_ref).max()
    assert torch.equal(tk.right_apply_2d_q8(geno, bq_t), w)


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
        v, s, e, load, _ = pca_core(sm, b0.to(dev), 4, 5)
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


# ---------------------------------------------------------------------------
# The 1-D right products 4 and 11 in bf16 mode: the narrow kernel (L <= 16)
# and the wide route (right2d_mma_kernel's f32 store).

RIGHT1D = {"packed": "fused_right_apply_packed", "dense": "fused_right_apply"}
RIGHT2D = {"packed": "fused_right_apply_2d_packed", "dense": "fused_right_apply_2d"}


def _device_case(device, layout, d, n, ell, seed):
    """Genotypes made on the card (packed: random bytes, a quarter of the
    codes missing; dense: dosages {0, 1, 2}, 2% missing, 1% odd dosages in
    [-100, 100)), moments with an inert row, and B (4 ceil(n / 4), ell)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    if layout == "packed":
        geno = torch.randint(0, 256, (d, -(-n // 4)), generator=gen, device=device,
                             dtype=torch.uint8)
    else:
        geno = torch.randint(0, 3, (d, n), generator=gen, device=device,
                             dtype=torch.int8)
        u = torch.rand((d, n), generator=gen, device=device)
        odd = torch.randint(-100, 100, (d, n), generator=gen, device=device,
                            dtype=torch.int8)
        geno = torch.where(u < 0.01, odd, torch.where(u > 0.98, -127, geno))
    mu = torch.rand((d, 1), generator=gen, device=device) * 2
    inv = torch.rand((d, 1), generator=gen, device=device) + 0.5
    inv[min(5, d - 1)] = 0.0
    n_b = tk._samples(geno)
    b = torch.randn((n_b, ell), generator=gen, device=device) / n ** 0.5
    return geno, mu, inv, b


@pytest.mark.cuda
@pytest.mark.parametrize("ell", [1, 3, 8, 10, 16])
@pytest.mark.parametrize("d,n", [(262_144, 2_048), (65_536, 10_000), (2_048, 2_048),
                                 (70_001, 2_504)])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_narrow_kernel_matches_plain_and_repeats(cuda_device, monkeypatch, layout,
                                                       d, n, ell):
    """Kernels 4 and 11 in bf16 mode with L <= 16: one C call of
    right_narrow_mma_kernel, within 1e-5 of max|plain| (the same bf16
    operands, f32 sums in another order), and a second launch bit for bit
    (no atomics; the 2,048 x 2,048 strip splits its samples, whose slab is
    added in a fixed order).  The 1-D main shape, the dense EigenSNP
    finalize's, a streamed strip and a ragged shape (70,001 rows, 2,504
    samples: 626 packed bytes a row, copied to 640)."""
    geno, mu, inv, b = _device_case(cuda_device, layout, d, n, ell, d + n + ell)
    name = RIGHT1D[layout]
    entries = _spy_entries(monkeypatch)
    got, ref = _launch_twice(name, (geno, mu, inv, b), "bf16")
    assert entries == [tk._ENTRY[geno.dtype]["right_narrow"]] * 2
    assert got.shape == ref.shape == (d, ell)
    err = float((got - ref).abs().max())
    assert err <= 1e-5 * float(ref.abs().max()), err
    splits = tk.right_narrow_plan(d, tk._samples(tk.aligned_rows(geno)), ell,
                                  geno.dtype)[2]
    assert (splits > 1) == (d == 2_048)


@pytest.mark.cuda
@pytest.mark.parametrize("d,n", [(2_048, 2_048), (4_096, 1_024), (300, 2_100)])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_1d_wide_route_is_the_2d_right_product(cuda_device, monkeypatch, layout,
                                                     d, n):
    """A bf16 call with L = 128 (the streamed tsq pass's) takes
    right2d_mma_kernel's f32 store: it equals kernels 5 / 13 on the same
    inputs bit for bit, split or not, and makes their C call."""
    geno, mu, inv, b = _device_case(cuda_device, layout, d, n, 128, d + n)
    entries = _spy_entries(monkeypatch)
    got, ref = _launch_twice(RIGHT1D[layout], (geno, mu, inv, b), "bf16")
    assert entries == [tk._ENTRY[geno.dtype]["right2d"]] * 2
    assert torch.equal(got, getattr(tk, RIGHT2D[layout])(geno, mu, inv, b))
    assert float((got - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


@pytest.mark.cuda
def test_right_narrow_plan(cuda_device):
    """The tile, blocks, sample splits, chunk and workspace the library
    launches the narrow kernel with on 132 SMs: 256 rows x 16 columns a
    tile; a chunk is 128 bytes of a row (512 samples packed, 128 dense).
    At 262,144 x 2,048 its 1,024 tiles take a persistent grid of 132
    blocks; at 65,536 x 10,000 (dense) 256 tiles; a strip of 2,048 rows has
    8 tiles, so the samples split into as many ranges as there are chunks,
    up to 16; wider B adds a column block of 16 a tile.  The workspace is
    B in the kernel's order (512 bytes a K step of 16 samples and column
    block), then the ranges' f32 slab."""
    u8, i8 = torch.uint8, torch.int8
    assert tk.right_narrow_plan(262_144, 2_048, 10, u8, 132) == (
        (256, 16), 132, 1, 512, 128 * 512)
    assert tk.right_narrow_plan(262_144, 2_048, 10, i8, 132) == (
        (256, 16), 132, 1, 128, 128 * 512)
    assert tk.right_narrow_plan(65_536, 10_000, 10, i8, 132) == (
        (256, 16), 132, 1, 128, 79 * 8 * 512)
    assert tk.right_narrow_plan(2_048, 2_048, 10, u8, 132) == (
        (256, 16), 8, 4, 512, 128 * 512 + 4 * 2_048 * 10 * 4)
    assert tk.right_narrow_plan(2_048, 2_048, 10, i8, 132) == (
        (256, 16), 8, 16, 128, 128 * 512 + 16 * 2_048 * 10 * 4)
    assert tk.right_narrow_plan(2_048, 2_048, 32, i8, 132) == (
        (256, 16), 16, 8, 128, 2 * 128 * 512 + 8 * 2_048 * 32 * 4)
    assert tk.right_narrow_plan(70_001, 2_560, 16, u8, 132) == (
        (256, 16), 132, 1, 512, 5 * 32 * 512)
    assert tk.right_narrow_plan(100, 256, 1, u8, 1) == ((256, 16), 1, 1, 512, 32 * 512)


@pytest.mark.cuda
@pytest.mark.parametrize("ell", [10, 40])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_narrow_launch_follows_its_plan(cuda_device, layout, ell):
    """The C entry builds B in the workspace in `right_narrow_operand`'s
    order, bit for bit, refuses a call without a workspace, and with the
    workspace the plan sizes (the slab after B where it splits the
    samples) gives the wrapper's result; 1,030 samples of B against rows
    of 2,048 (their pad meets zero rows of B), L = 10 and 40 (3 column
    blocks)."""
    for d, want_split in ((2_048, True), (65_536, False)):
        geno, mu, inv, b = _device_case(cuda_device, layout, d, 2_048, ell, d)
        b = b[:1_030].contiguous()
        b_full = torch.zeros((tk._samples(geno), ell), device=cuda_device)
        b_full[:1_030] = b
        n = tk._samples(geno)
        _, _, splits, chunk, work_bytes = tk.right_narrow_plan(d, n, ell, geno.dtype)
        assert (splits > 1) == want_split
        op = tk.right_narrow_operand(b, chunk, n)
        assert work_bytes == op.numel() * 2 + (splits * d * ell * 4 if splits > 1 else 0)
        out = torch.empty((d, ell), device=cuda_device)
        entry = tk._ENTRY[geno.dtype]["right_narrow"]
        args = (geno, mu, inv, b, out)
        tail = (d, n // 4, 1_030, ell, tk._sms(cuda_device))
        with pytest.raises(RuntimeError, match="failed"):
            tk._launch(cuda_device, entry, *args, None, *tail)
        work = torch.empty(work_bytes, dtype=torch.uint8, device=cuda_device)
        tk._launch(cuda_device, entry, *args, work, *tail)
        assert torch.equal(work[:op.numel() * 2].view(torch.bfloat16).view(op.shape), op)
        name = RIGHT1D[layout]
        if ell <= 16:
            assert torch.equal(out, getattr(tk, name)(geno, mu, inv, b_full))
        ref = tk.PLAIN[name](geno, mu, inv, b_full, "bf16")
        assert float((out - ref).abs().max()) <= 1e-5 * float(ref.abs().max())


# ---------------------------------------------------------------------------
# The stage 1-2 block batch: standardize_runs, bit for bit its plain version.

# (rows, samples, starts, lens, bucket): an interior run, a run ending on
# the last row, batch padding (length 0) and a bucket longer than the runs
# at an odd sample count (packed rows of 251 bytes: the group-a-pass loads)
# and at 4,096 (rows of whole 32-bit words: the shuffled loads); the UK
# Biobank chunk (1, 512, 407,552); kgp3's (4, 25,600, 2,560).
RUN_CASES = {
    "odd": (300, 1_001, [5, 240, 0], [50, 60, 0], 64),
    "words": (300, 4_096, [5, 240, 0], [50, 60, 0], 64),
    "ukb_chunk": (600, 407_552, [40], [56], 512),
    "kgp3_chunk": (102_500, 2_560, [0, 25_600, 51_200, 76_900],
                   [25_600, 25_000, 24_000, 25_600], 25_600),
}


# The launch count of each layout's kernel.
RUNS_LAUNCH = {"packed": "standardize_runs", "dense": "standardize_runs_i8"}


def _runs_case(device, layout: str, d: int, n: int):
    """Genotypes with 10% missing calls (dense rows padded to whole words
    with -127, as the container pads them) and moments with inv_std 0 on
    row 7, on the card."""
    rng = np.random.default_rng(24)
    g = rng.integers(0, 3, size=(d, n), dtype=np.int8)
    g[rng.random((d, n), dtype=np.float32) < 0.1] = -127
    if layout == "packed":
        geno = pack_int8_rows(g)
    else:
        geno = np.full((d, -(-n // 4) * 4), -127, np.int8)
        geno[:, :n] = g
    mean = rng.uniform(0.2, 1.8, (d, 1)).astype(np.float32)
    inv = rng.uniform(0.5, 3.0, (d, 1)).astype(np.float32)
    inv[7] = 0.0
    return _on(device, geno, mean, inv)


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(RUN_CASES))
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_standardize_runs_kernel_is_plain_bit_for_bit(cuda_device, layout, case):
    d, n, starts, lens, bucket = RUN_CASES[case]
    geno, mu, inv = _runs_case(cuda_device, layout, d, n)
    starts, lens = np.array(starts), np.array(lens)
    name = RUNS_LAUNCH[layout]
    tk.reset_launch_counts()
    got = tk.standardize_runs(geno, mu, inv, starts, lens, bucket)
    torch.cuda.synchronize()
    assert tk.LAUNCHES == dict(ZERO, **{name: 1})
    ref = tk.standardize_runs_plain(geno, mu, inv, torch.as_tensor(starts, device=cuda_device),
                                    torch.as_tensor(lens, device=cuda_device), bucket)
    np.testing.assert_array_equal(got.cpu().numpy(), ref.cpu().numpy())
    del ref
    again = tk.standardize_runs(geno, mu, inv, starts, lens, bucket)
    assert tk.LAUNCHES == dict(ZERO, **{name: 2})
    assert torch.equal(again, got)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_fetch_blocks_device_on_the_card_counts_the_kernel(cuda_device, layout):
    """The container's block batch on the card is the CPU container's,
    bit for bit, through one launch and one count."""
    from genomic_pca_tpu_torch.utils import profiling

    rng = np.random.default_rng(25)
    g = balding_nichols(rng, 700, 301, missing_rate=0.1, n_pops=3, fst=0.1)
    valid = g != -127
    mean = (np.where(valid, g, 0).sum(1) / valid.sum(1)).astype(np.float32)
    std = np.where(valid, g, 0).std(1).astype(np.float32)
    std[3] = 0.0
    starts, lens = np.array([0, 300, 500, 0]), np.array([120, 200, 200, 0])
    outs = {}
    for dev in ("cpu", cuda_device):
        if layout == "packed":
            sm = ShardedMatrix.from_packed_rows(pack_int8_rows(g), mean, std, 301,
                                                device=dev)
        else:
            sm = ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                           device=dev)
        tk.reset_launch_counts()
        profiling.reset_counts()
        outs[str(dev)] = sm.fetch_blocks_device(starts, lens, 256).cpu().numpy()
        want = 1 if dev != "cpu" else None
        assert profiling.COUNTS.get("block_fetch_kernel") == want
        assert tk.LAUNCHES == dict(ZERO, **{RUNS_LAUNCH[layout]: want or 0})
    np.testing.assert_array_equal(outs["cuda"], outs["cpu"])

"""The q8 left product sum_t sz[t] G0_t^T z8_t of the 2-D mode (kernels 8
and 8i) on the CPU.

On a CUDA tensor `left_apply_2d_q8` runs the s8 tensor-core kernel
(csrc/q8_left2d_kernels.cu): each row tile's exact int32 sum is folded
into an f32 total in tile order, and where the plan splits the rows, the
ranges' partials are added in range order.  Here its plain version, which
folds in that order, is held to the JAX kernel in interpret mode (the
reference folds in tile order too), to a float64 replay, and bit for bit
to an explicit float32 replay of the order at any ranges; the operand the
C call builds (z8^T) is stated by `q8_left_operand`.  The kernel itself is
held to the plain version on the card in tests/test_torch_cuda.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu_torch.ops import build
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows

TILE_N4 = 128  # the JAX byte tile of the packed layout: two per row here


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(rng, d, n, ell, tile_d):
    """Unstructured dosages {0, 1, 2} with 5% missing and row 7 all
    missing, a random z8 (d, ell) and per-tile scales."""
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -127
    g[7] = -127
    z8 = rng.integers(-127, 128, size=(d, ell)).astype(np.int8)
    sz = rng.uniform(0.01, 0.1, size=-(-d // tile_d)).astype(np.float32)
    return g, z8, sz


def _geno(g, layout):
    return pack_int8_rows(g) if layout == "packed" else g


def _replay_f32(g, z8, sz, tile_d, ranges=(0,)):
    """The kernel's order in numpy float32: each tile's int64 product
    converted once, out = out + P_t * sz[t] from zeros (two roundings),
    each range apart, the ranges added in order."""
    g0 = np.maximum(g, 0).astype(np.int64)
    d = g.shape[0]
    bounds = [*ranges, -(-d // tile_d)]
    total = None
    for lo, hi in zip(bounds, bounds[1:]):
        part = np.zeros((g.shape[1], z8.shape[1]), np.float32)
        for t in range(lo, hi):
            rows = slice(t * tile_d, min(d, (t + 1) * tile_d))
            prod = (g0[rows].T @ z8[rows].astype(np.int64)).astype(np.float32)
            part = part + prod * np.float32(sz[t])
        total = part if total is None else total + part
    return total


def _replay_fma(g, z8, sz, tile_d):
    """The fold with one rounding a tile: out = fl(out + P_t sz[t]), the
    product and the sum exact in float64 before the one rounding to f32."""
    g0 = np.maximum(g, 0).astype(np.int64)
    out = np.zeros((g.shape[1], z8.shape[1]), np.float32)
    for lo in range(0, g.shape[0], tile_d):
        prod = (g0[lo:lo + tile_d].T @ z8[lo:lo + tile_d].astype(np.int64)).astype(np.float64)
        out = (out.astype(np.float64) + prod * np.float64(sz[lo // tile_d])).astype(np.float32)
    return out


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("tile_d", [32, 64, 128])
def test_left_2d_q8_plain_matches_jax(rng, layout, tile_d):
    """The tile-ordered plain version against the JAX kernel in interpret
    mode on the same z8 and scales (packed output un-permuted from the
    tile-local plane-major order), at the bars used so far (rtol and atol
    1e-5).  Not bit for bit: both fold in row-tile order, but XLA on the
    CPU contracts the reference's `out += t.astype(f32) * sz` into one
    FMA (an FMA replay of the fold gives its bits), where the plain
    version and the card's kernel round the multiply and the add apart
    (the two-rounding replay gives theirs)."""
    d, n, ell = 256, 1024, 128
    g, z8, sz = _case(rng, d, n, ell, tile_d)
    geno = _geno(g, layout)
    ref = np.asarray(pk.left_apply_2d_q8(
        jnp.asarray(geno), jnp.asarray(z8), jnp.asarray(sz), tile_d=tile_d,
        tile_n=TILE_N4 if layout == "packed" else 512, interpret=True,
    ))
    if layout == "packed":
        ref = ref[np.argsort(pk.plane_major_perm_tiled(n, TILE_N4))]
    got = tk.left_apply_2d_q8(_t(geno), _t(z8), _t(sz), tile_d).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_array_equal(ref, _replay_fma(g, z8, sz, tile_d))
    np.testing.assert_array_equal(got, _replay_f32(g, z8, sz, tile_d))
    assert (got != ref).any()


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("d,tile_d", [(300, 64), (1000, 128), (77, 32)])
def test_left_2d_q8_plain_matches_float64_replay(rng, layout, d, tile_d):
    """At a ragged D whose last row tile is partial: the plain version
    against sum_t sz[t] G0_t^T z8_t in float64, to f32 rounding."""
    g, z8, sz = _case(rng, d, 516, 130, tile_d)
    got = tk.left_apply_2d_q8(_t(_geno(g, layout)), _t(z8), _t(sz), tile_d).numpy()
    g0 = np.maximum(g, 0).astype(np.float64)
    replay = sum(g0[lo:lo + tile_d].T @ z8[lo:lo + tile_d].astype(np.float64)
                 * float(sz[lo // tile_d]) for lo in range(0, d, tile_d))
    assert got.shape == (516, 130)
    np.testing.assert_allclose(got, replay, rtol=1e-5, atol=1e-5 * np.abs(replay).max())


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("ranges", [(0,), (0, 1), (0, 2, 5), (0, 3, 4, 6, 8)])
def test_left_2d_q8_plain_ranges_fold_in_the_kernels_order(rng, layout, ranges):
    """`ranges` (the first row tile of each range, as `q8_left2d_plan`
    reports them) against an explicit numpy float32 replay of the order:
    each range folds its tiles from zeros, the ranges are added in order;
    bit for bit.  Splits change the bits, which is why the card's kernel is
    held to the plain version at its own plan's ranges."""
    d, tile_d = 9 * 64 - 20, 64  # 9 tiles, the last ragged
    g, z8, sz = _case(rng, d, 256, 128, tile_d)
    geno, z, s = _t(_geno(g, layout)), _t(z8), _t(sz)
    got = tk.left_apply_2d_q8_plain(geno, z, s, tile_d, ranges)
    np.testing.assert_array_equal(got.numpy(), _replay_f32(g, z8, sz, tile_d, ranges))
    if len(ranges) > 2:
        assert not torch.equal(got, tk.left_apply_2d_q8_plain(geno, z, s, tile_d))


@pytest.mark.parametrize("ranges", [(1,), (0, 0), (0, 3, 2), (0, 9)])
def test_left_2d_q8_plain_refuses_ranges_out_of_order(rng, ranges):
    g, z8, sz = _case(rng, 9 * 64, 64, 16, 64)
    with pytest.raises(ValueError, match="ranges"):
        tk.left_apply_2d_q8_plain(_t(g), _t(z8), _t(sz), 64, ranges)


@pytest.mark.parametrize("d,ell", [(300, 10), (1024, 128), (77, 130)])
def test_q8_left_operand_is_z8_transposed_with_zero_pads(rng, d, ell):
    """z8^T, (L_pad, D_pad) int8 contiguous, both padded to multiples of
    16; every pad entry 0, so that rows past D meet zero columns."""
    z8 = _t(rng.integers(-127, 128, size=(d, ell)).astype(np.int8))
    op = tk.q8_left_operand(z8)
    assert op.dtype == torch.int8 and op.is_contiguous()
    assert tuple(op.shape) == (-(-ell // 16) * 16, -(-d // 16) * 16)
    assert torch.equal(op[:ell, :d], z8.T)
    pad = op.clone()
    pad[:ell, :d] = 0
    assert not bool(pad.any())


@pytest.mark.parametrize("sms", [None, 132])
def test_q8_left2d_plan_without_cuda_raises_as_q8_right2d_plan_does(monkeypatch,
                                                                    tmp_path, sms):
    """The plan is read from the built kernel library: without CUDA (no
    device for the SM count, no nvcc to build with) `q8_left2d_plan`
    raises the error `q8_right2d_plan` raises, and reports no plan."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    errors = []
    for plan in (lambda: tk.q8_right2d_plan(65_536, 16_384, 128, sms),
                 lambda: tk.q8_left2d_plan(65_536, 16_384, 128, 1024, sms)):
        with pytest.raises(Exception) as info:
            plan()
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


@pytest.mark.parametrize("layout", ["packed", "dense"])
@pytest.mark.parametrize("tile_d", [4, 48])
def test_left_2d_q8_plain_route_takes_any_tile(rng, layout, tile_d):
    """On a CPU tensor the wrapper runs the plain version for any positive
    tile (the card's kernel needs whole K steps of 32 rows), counts no
    launch, and validates its inputs."""
    g, z8, sz = _case(rng, 100, 64, 16, tile_d)
    geno = _t(_geno(g, layout))
    tk.reset_launch_counts()
    got = tk.left_apply_2d_q8(geno, _t(z8), _t(sz), tile_d)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    np.testing.assert_array_equal(got.numpy(), _replay_f32(g, z8, sz, tile_d))
    with pytest.raises(ValueError):
        tk.left_apply_2d_q8(geno, _t(z8), _t(sz[:-1]), tile_d)
    with pytest.raises(TypeError):
        tk.left_apply_2d_q8(geno, _t(z8).to(torch.int16), _t(sz), tile_d)
    with pytest.raises(ValueError):
        tk.left_apply_2d_q8(geno, _t(z8[:-1]), _t(sz), tile_d)
    with pytest.raises(ValueError):
        tk.left_apply_2d_q8(geno, _t(z8), _t(sz), 0)


def test_mma2d_ab_q8left_checks_through_the_wrappers_and_needs_cuda(monkeypatch):
    """The A/B timer's q8 left line holds kernels 8 and 8i to the
    tile-ordered fold through the wrapper before it times anything (on the
    CPU the wrapper runs the plain version, so it agrees bit for bit at its
    check shapes), and the timer exits 1 without a CUDA device."""
    from genomic_pca_tpu_torch.eval import mma2d_ab

    cpu = torch.device("cpu")
    rng = np.random.default_rng(3)
    for layout in mma2d_ab.LAYOUTS:
        assert mma2d_ab.agrees("q8left", layout, 70, 256, 10, cpu)
        assert mma2d_ab.agrees("q8left", layout, *mma2d_ab.CHECKS["q8left"][1], cpu)
        geno, z8, sz = (_t(x) for x in _case(rng, 200, 128, 16, 64))
        assert torch.equal(mma2d_ab.tile_ordered(geno, z8, sz, 64, (0, 2)),
                           tk.left_apply_2d_q8_plain(geno, z8, sz, 64, (0, 2)))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mma2d_ab.main(["tag", "--lines", "q8left"]) == 1

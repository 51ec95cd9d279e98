"""The port's wide-sample (2-D) mode against the JAX package's.

Kernels 5-8 (`ops/kernels.py`, plain versions on the CPU) against the
JAX 2-D kernels in interpret mode, and the port's container in mode "2d"
against the JAX `ShardedMatrix(mode="pallas2d_interpret")` holding the
same bytes.  The JAX 2-D kernels take and return sample-indexed arrays in
tile-local plane-major order (`plane_major_perm_tiled`), so the JAX side
is permuted here; the port stays in original order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu.parallel import sharded as js
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.ops.rsvd import quantize_basis
from genomic_pca_tpu_torch.parallel import sharded as ts
from tests.conftest import make_genotypes
from tests.test_torch_sharded import _moments
from tests.torch_cases import abs_corr, padded_packed, q8_case, quant_model

TILE_N4 = 128  # JAX byte tile of these tests: two or more per row


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


@pytest.fixture
def wide_case(rng):
    """(packed (64, 256), mean, inv_std, b (1024, 128)) with missing
    genotypes and an inert row; 1,024 samples = two JAX byte tiles."""
    d, n = 64, 1024
    geno = make_genotypes(rng, d, n, missing_rate=0.05)
    packed = padded_packed(geno)[:, : n // 4]
    valid = geno != -127
    g0 = np.where(valid, geno, 0).astype(np.float64)
    mu = (g0.sum(1) / valid.sum(1)).astype(np.float32)[:, None]
    inv = (1.0 / (g0.std(1) + 0.1)).astype(np.float32)[:, None]
    inv[3] = 0.0
    b = (rng.standard_normal((n, 128)) / np.sqrt(n)).astype(np.float32)
    return packed, mu, inv, b


# (rtol, atol) of the reference's own 2-D packed tests
# (tests/test_packed_kernels.py:289-321) for bf16; f32 differs only in the
# order of f32 sums.
TOL = {"f32": (1e-4, 1e-4), "bf16": (1e-2, 1e-3)}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_right_2d_plain_matches_jax(wide_case, precision):
    packed, mu, inv, b = wide_case
    perm = pk.plane_major_perm_tiled(b.shape[0], TILE_N4)
    ref = np.asarray(pk.fused_right_apply_2d_packed(
        jnp.asarray(packed), jnp.asarray(mu), jnp.asarray(inv),
        jnp.asarray(b[perm]), tile_d=32, tile_n4=TILE_N4, precision=precision,
        interpret=True,
    ))
    got = tk.fused_right_apply_2d_packed(_t(packed), _t(mu), _t(inv), _t(b),
                                         precision=precision)
    np.testing.assert_allclose(got.numpy(), ref, *TOL[precision])


@pytest.mark.parametrize("ell", [10, 130])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_right_2d_plain_matches_jax_at_hard_cases(rng, precision, ell):
    """Kernel 5's plain version, which tests/test_torch_cuda.py holds the
    tensor-core kernel to, against the JAX kernel at the GPU test's hard
    cases the reference's tiling admits: L = 10 (the loadings launch) and
    130 (past one 128-column tile), 5% missing, an inert row, 96 rows of
    1,024 samples (three row tiles, two sample tiles)."""
    d, n = 96, 1024
    geno = make_genotypes(rng, d, n, missing_rate=0.05)
    packed = padded_packed(geno)[:, : n // 4]
    valid = geno != -127
    g0 = np.where(valid, geno, 0).astype(np.float64)
    mu = (g0.sum(1) / valid.sum(1)).astype(np.float32)[:, None]
    inv = (1.0 / (g0.std(1) + 0.1)).astype(np.float32)[:, None]
    inv[7] = 0.0
    b = (rng.standard_normal((n, ell)) / np.sqrt(n)).astype(np.float32)
    perm = pk.plane_major_perm_tiled(n, TILE_N4)
    ref = np.asarray(pk.fused_right_apply_2d_packed(
        jnp.asarray(packed), jnp.asarray(mu), jnp.asarray(inv),
        jnp.asarray(b[perm]), tile_d=32, tile_n4=TILE_N4, precision=precision,
        interpret=True,
    ))
    tk.reset_launch_counts()
    got = tk.fused_right_apply_2d_packed(_t(packed), _t(mu), _t(inv), _t(b),
                                         precision=precision)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert not got[7].any()
    np.testing.assert_allclose(got.numpy(), ref, *TOL[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_left_2d_plain_matches_jax(wide_case, precision):
    packed, mu, inv, b = wide_case
    w = (b[:64] * 3.0).astype(np.float32)  # (D, L) f32, not bf16-exact
    invp = np.argsort(pk.plane_major_perm_tiled(b.shape[0], TILE_N4))
    ref = np.asarray(pk.fused_left_apply_2d_packed(
        jnp.asarray(packed), jnp.asarray(mu), jnp.asarray(inv), jnp.asarray(w),
        tile_d=32, tile_n4=TILE_N4, precision=precision, interpret=True,
    ))[invp]
    got = tk.fused_left_apply_2d_packed(_t(packed), _t(mu), _t(inv), _t(w),
                                        precision=precision)
    np.testing.assert_allclose(got.numpy(), ref, *TOL[precision])


def test_right_2d_q8_plain_is_the_exact_integer_product(rng):
    """Kernel 7's plain version equals the JAX kernel and the int64
    product bit for bit: the sums are integers below 2^24."""
    d, n = 64, 1024
    g, _, _, bq, _, _ = q8_case(rng, d, n, 128)
    packed = ts.pack_int8_rows(g)
    perm = pk.plane_major_perm_tiled(n, TILE_N4)
    ref = np.asarray(pk.right_apply_2d_q8(
        jnp.asarray(packed), jnp.asarray(bq[perm]), tile_d=32, tile_n=TILE_N4,
        interpret=True,
    ))
    got = tk.right_apply_2d_q8(_t(packed), _t(bq)).numpy()
    exact = np.maximum(g, 0).astype(np.int64) @ bq.astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, exact.astype(np.float32))


def test_left_2d_q8_plain_matches_jax_and_replay(rng):
    """Kernel 8's plain version against the JAX kernel on the same z8 and
    scales, and against a float64 replay: only the f32 sum over row tiles
    differs (rtol 1e-5)."""
    d, n, ell, tile_d = 128, 1024, 128, 32
    g = make_genotypes(rng, d, n, missing_rate=0.02)
    packed = ts.pack_int8_rows(g)
    z8 = rng.integers(-127, 128, size=(d, ell)).astype(np.int8)
    sz = rng.uniform(0.01, 0.1, size=d // tile_d).astype(np.float32)
    invp = np.argsort(pk.plane_major_perm_tiled(n, TILE_N4))
    ref = np.asarray(pk.left_apply_2d_q8(
        jnp.asarray(packed), jnp.asarray(z8), jnp.asarray(sz), tile_d=tile_d,
        tile_n=TILE_N4, interpret=True,
    ))[invp]
    got = tk.left_apply_2d_q8(_t(packed), _t(z8), _t(sz), tile_d).numpy()
    g0 = np.maximum(g, 0).astype(np.float64)
    replay = sum(g0[lo:lo + tile_d].T @ z8[lo:lo + tile_d].astype(np.float64)
                 * float(sz[lo // tile_d]) for lo in range(0, d, tile_d))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, replay, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("d,tile_d", [(512, 128), (300, 64)])
def test_q8_power_pass_2d_matches_quant_model(rng, d, tile_d):
    """At the port's own tile, a ragged last tile included (d = 300); the
    bar of the reference's own q8 test (tests/test_q8.py:156-175)."""
    g, iv, u, bq, sb, csum = q8_case(rng, d, 256, 128)
    out, ru = tk.q8_power_pass_2d(_t(ts.pack_int8_rows(g)), _t(iv), _t(u),
                                  _t(bq), _t(sb), _t(csum), tile_d=tile_d)
    ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    np.testing.assert_allclose((out - ru).numpy(), ref, rtol=1e-4, atol=1e-2)


def test_q8_power_pass_2d_matches_jax_at_equal_tile(rng):
    d, n, ell, tile_d = 256, 1024, 128, 128
    g, iv, u, bq, sb, csum = q8_case(rng, d, n, ell)
    packed = ts.pack_int8_rows(g)
    perm = pk.plane_major_perm_tiled(n, TILE_N4)
    out_j, ru_j = pk.q8_power_pass_2d(
        jnp.asarray(packed), jnp.asarray(iv), jnp.asarray(u),
        jnp.asarray(bq[perm]), jnp.asarray(sb), jnp.asarray(csum),
        tile_d=tile_d, tile_n=TILE_N4, interpret=True,
    )
    ref = (np.asarray(out_j) - np.asarray(ru_j))[np.argsort(perm)]
    out, ru = tk.q8_power_pass_2d(_t(packed), _t(iv), _t(u), _t(bq), _t(sb),
                                  _t(csum), tile_d=tile_d)
    np.testing.assert_allclose((out - ru).numpy(), ref, rtol=1e-4, atol=1e-2)
    # The 1-D plain pass is the same quantization model.
    out1, ru1 = tk.fused_gram_q8_packed(_t(packed), _t(iv), _t(u), _t(bq),
                                        _t(sb), _t(csum), tile_d=tile_d)
    np.testing.assert_array_equal((out1 - ru1).numpy(), (out - ru).numpy())


# ---------------------------------------------------------------------------
# The mode rule: the port switches where the JAX container does.


@pytest.mark.parametrize("n_pad,precision,mode", [
    (10_752, "q8", "1d"), (11_264, "q8", "2d"),
    (10_752, "bf16", "1d"), (11_264, "bf16", "2d"),
    (8_704, "f32", "1d"), (9_216, "f32", "2d"),
])
def test_mode_switches_where_the_reference_does(n_pad, precision, mode):
    assert ts.default_mode(n_pad, precision) == mode
    assert (js.auto_tile_d(n_pad, precision=precision) == 0) == (mode == "2d")
    # One row of n_pad / 4 bytes: no wide matrix is allocated.
    geno = torch.full((1, n_pad // 4), 0x55, dtype=torch.uint8)
    col = torch.zeros((1, 1))
    sm = ts.ShardedMatrix(geno, col, col, 1, n_pad, "cpu",
                          kernel_precision=precision)
    assert sm.mode == mode
    assert ts.ShardedMatrix(geno, col, col, 1, n_pad, "cpu", mode="1d",
                            kernel_precision=precision).mode == "1d"


# ---------------------------------------------------------------------------
# The 2-D container against the JAX container on the same bytes.


def _pair2d(rng, precision, d=128, n=2100, n_pops=4, fst=0.2, tile_d=32):
    """JAX 2-D container (1-device mesh, byte tile 128 -> 5 tiles) and the
    port's 2-D container holding its arrays; the port's q8 tile is the
    JAX container's 2-D q8 tile."""
    g = make_genotypes(rng, d, n, missing_rate=0.03, n_pops=n_pops, fst=fst)
    mean, std = _moments(g)
    sm_j = js.ShardedMatrix.from_packed_rows(
        js.pack_int8_rows(g), mean, std, n, mesh=make_mesh(jax.devices()[:1]),
        mode="pallas2d_interpret", tile_d=tile_d, kernel_precision=precision,
    )
    assert sm_j.tile_n == TILE_N4 and sm_j.geno.shape[1] // TILE_N4 >= 2
    geno = np.asarray(sm_j.geno)
    q8_tile = js._q8_packed_tile_d_2d(geno.shape[0], TILE_N4, 128, tile_d)
    sm_t = ts.ShardedMatrix.from_reference_arrays(
        geno, np.asarray(sm_j.mean), np.asarray(sm_j.inv_std), d, n, "cpu",
        tile_d=q8_tile, kernel_precision=precision, mode="2d",
    )
    return g, sm_j, sm_t


# The reference's own 2-D container test (tests/test_packed_kernels.py:
# 324-365) holds pallas2d to its XLA scan at these tolerances.
@pytest.mark.parametrize("name,atol", [
    ("gram_apply", 1e-2), ("tsq_accumulate", 1e-1), ("right_apply", 1e-2),
])
def test_2d_passes_match_reference(rng, name, atol):
    _, sm_j, sm_t = _pair2d(rng, "f32")
    b = np.random.default_rng(8).standard_normal((2100, 6)).astype(np.float32)
    ref = np.asarray(getattr(sm_j, name)(jnp.asarray(b)))
    got = getattr(sm_t, name)(torch.from_numpy(b))
    got = got if isinstance(got, np.ndarray) else got.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol)


# q8: an f32-level difference in z can flip one 8-bit rounding, so the
# eigenvalues are held to 5e-3 (tests/test_q8.py:112-114).
@pytest.mark.parametrize("precision,s_rtol", [("f32", 1e-4), ("q8", 5e-3)])
def test_2d_power_iterate_and_pca_core_match_reference(rng, precision, s_rtol):
    _, sm_j, sm_t = _pair2d(rng, precision)
    b0 = np.random.default_rng(6).standard_normal((2100, 8)).astype(np.float32)
    q_j = np.asarray(sm_j.power_iterate(jnp.asarray(b0), 4))
    q_t = sm_t.power_iterate(torch.from_numpy(b0), 4).numpy()
    for j in range(3):  # the separated prefix (n_pops - 1)
        assert abs_corr(q_j[:, j], q_t[:, j]) > 0.9999, j
    v_j, s_j, e_j, l_j = sm_j.pca_core(jnp.asarray(b0), 4, 3)
    v_t, s_t, e_t, l_t = sm_t.pca_core(torch.from_numpy(b0), 4, 3)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), rtol=s_rtol)
    np.testing.assert_allclose(e_t.numpy(), np.asarray(e_j), rtol=2 * s_rtol)
    for j in range(3):
        assert abs_corr(np.asarray(v_j)[:, j], v_t.numpy()[:, j]) > 0.9999, j
        assert abs_corr(l_j[:, j], l_t[:, j]) > 0.9999, j


def test_2d_tsq_takes_w_in_f32_and_1d_in_bf16(rng):
    """The two modes differ where the reference's do: 2-D tsq is W^T W on
    the f32 W, 1-D tsq rounds W to bf16 first."""
    _, sm_j, sm_t = _pair2d(rng, "bf16")
    b = torch.from_numpy(
        np.random.default_rng(9).standard_normal((2100, 4)).astype(np.float32))
    w = sm_t._right(sm_t._pad_b(b))
    np.testing.assert_array_equal(sm_t.tsq_accumulate(b).numpy(), (w.T @ w).numpy())
    sm_1d = ts.ShardedMatrix(sm_t.geno, sm_t.mean, sm_t.inv_std, sm_t.n_rows,
                             sm_t.n_samples, "cpu", kernel_precision="bf16",
                             mode="1d")
    wb = w.to(torch.bfloat16).to(torch.float32)
    np.testing.assert_allclose(sm_1d.tsq_accumulate(b).numpy(),
                               (wb.T @ wb).numpy(), rtol=1e-5, atol=1e-3)


# ---------------------------------------------------------------------------
# Device block slicing and the missing count.


@pytest.mark.parametrize("cols", [False, True])
def test_fetch_blocks_device_matches_reference(rng, cols):
    d, n = 300, 37
    g = make_genotypes(rng, d, n, missing_rate=0.1)
    mean, std = _moments(g)
    sm_j = js.ShardedMatrix.from_packed_rows(
        js.pack_int8_rows(g), mean, std, n, mesh=make_mesh(jax.devices()[:1]),
        mode="xla", tile_d=64,
    )
    sm_t = ts.ShardedMatrix.from_packed_rows(js.pack_int8_rows(g), mean, std,
                                             n, "cpu")
    # Runs: interior, a tail whose bucket passes the last row (the JAX
    # window moves back to end at its d_pad = 384), and batch padding.
    starts = np.array([5, 260, 0])
    lens = np.array([40, 40, 0])
    col_idx = np.array([0, 3, 4, 36, 17]) if cols else None
    ref = np.asarray(sm_j.fetch_blocks_device(
        starts, lens, 128,
        None if col_idx is None else jnp.asarray(col_idx, dtype=jnp.int32)))
    got = sm_t.fetch_blocks_device(
        starts, lens, 128, None if col_idx is None else torch.from_numpy(col_idx))
    width = ref.shape[2] if cols else n  # sample padding differs
    d_pad_j = sm_j.geno.shape[0]
    for b in range(2):
        off = starts[b] - min(starts[b], d_pad_j - 128)  # the JAX run offset
        np.testing.assert_allclose(
            got.numpy()[b, : lens[b], :width],
            ref[b, off : off + lens[b], :width], rtol=1e-6, atol=1e-6)
        assert not got[b, lens[b]:].any()
    assert not got[2].any()
    # A bucket longer than the matrix shrinks to it; the run stays at row 0.
    whole = sm_t.fetch_blocks_device(np.array([290]), np.array([10]), 512)
    assert whole.shape[1] == d and not whole[0, 10:].any()
    tail = sm_t.fetch_blocks_device(starts[1:2], lens[1:2], 128)
    np.testing.assert_array_equal(whole[0, :10].numpy(), tail[0, 30:40].numpy())
    assert sm_t.runs_device_sliceable(np.stack([starts, lens], 1))
    with pytest.raises(ValueError, match="longer than bucket"):
        sm_t.fetch_blocks_device(starts, np.array([65, 1, 0]), 64)


def test_count_missing_matches_reference(rng):
    d, n = 90, 37
    g = make_genotypes(rng, d, n, missing_rate=0.1)
    mean, std = _moments(g)
    sm_j = js.ShardedMatrix.from_packed_rows(
        js.pack_int8_rows(g), mean, std, n, mesh=make_mesh(jax.devices()[:1]),
        mode="xla", tile_d=64,
    )
    sm_t = ts.ShardedMatrix.from_packed_rows(js.pack_int8_rows(g), mean, std,
                                             n, "cpu")
    assert sm_t.count_missing() == sm_j.count_missing() == int((g == -127).sum())


def test_wide_wrappers_validate_and_route():
    packed = torch.full((8, 4), 0x55, dtype=torch.uint8)
    col = torch.zeros((8, 1))
    tk.reset_launch_counts()
    tk.fused_left_apply_2d_packed(packed, col, col, torch.zeros((8, 4)))
    for precision in ("bf16", "f32"):
        assert tk.fused_right_apply_2d_packed(
            packed, col, col, torch.zeros((16, 4)), precision=precision
        ).shape == (8, 4)
    tk.right_apply_2d_q8(packed, torch.zeros((16, 4), dtype=torch.int8))
    tk.left_apply_2d_q8(packed, torch.zeros((8, 4), dtype=torch.int8),
                        torch.ones(2), 4)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.right_apply_2d_q8(packed.to("meta"),
                             torch.zeros((16, 4), dtype=torch.int8, device="meta"))
    with pytest.raises(ValueError, match="w must be"):
        tk.fused_left_apply_2d_packed(packed, col, col, torch.zeros((7, 4)))
    with pytest.raises(ValueError, match="b must be"):
        tk.fused_right_apply_2d_packed(packed, col, col, torch.zeros((15, 4)))
    with pytest.raises(TypeError):
        tk.fused_right_apply_2d_packed(packed, col, col,
                                       torch.zeros((16, 4), dtype=torch.bfloat16))
    with pytest.raises(TypeError):
        tk.left_apply_2d_q8(packed, torch.zeros((8, 4)), torch.ones(2), 4)
    with pytest.raises(ValueError, match="sz"):
        tk.left_apply_2d_q8(packed, torch.zeros((8, 4), dtype=torch.int8),
                            torch.ones(3), 4)
    bq, sb, csum = quantize_basis(torch.zeros((16, 4)))
    with pytest.raises(ValueError, match="tile_d"):
        tk.q8_power_pass_2d(packed, col, col, bq, sb, csum, tile_d=100)
    with pytest.raises(ValueError, match="mode"):
        ts.ShardedMatrix(packed, col, col, 8, 16, "cpu", mode="pallas2d")


def test_left2d_w_operand_rounds_as_the_plain_version():
    """The one bf16 rounding of W (left products) and B (right products)
    in the wrappers, `mma_operand`, is the plain versions' `_round_bf16`,
    bit for bit, ties to even included; ragged columns are padded with
    zeros to whole 16-byte rows; and the shared operand preparation hands
    both products aligned rows and moments."""
    ties = np.array([0x3F808000, 0x3F818000, 0xBF808000, 0xBF818000,
                     0x3F807FFF, 0x3F808001, 0x7F7F8000, 0x00008000],
                    dtype=np.uint32).view(np.float32)
    rng = np.random.default_rng(0)
    for rows in (3, 252):  # a W of 3 variants, a B of 252 samples
        for ell in (8, 10, 128, 130):
            w = rng.standard_normal((rows, ell)).astype(np.float32) * 3.0
            w.reshape(-1)[: len(ties)] = ties
            w_t = _t(w)
            op = tk.mma_operand(w_t)
            assert op.dtype == torch.bfloat16
            assert op.shape == (rows, -(-ell // 8) * 8) and op.is_contiguous()
            assert torch.equal(op[:, :ell].float().view(torch.int32),
                               tk._round_bf16(w_t).view(torch.int32))
            assert not op[:, ell:].float().any()
    # Round to nearest, ties to even: 1 + 2^-8 -> 1, 1 + 3 * 2^-8 -> 1 + 2^-6.
    got = tk.mma_operand(_t(ties[:4].reshape(1, 4)))[:, :4].view(torch.int16)
    assert got.numpy().view(np.uint16).tolist() == [[0x3F80, 0x3F82, 0xBF80, 0xBF82]]
    packed = torch.full((4, 63), 0x55, dtype=torch.uint8)
    col = torch.zeros(5)[1:].reshape(4, 1)  # a 4-byte offset from its base
    b = _t(rng.standard_normal((252, 10)).astype(np.float32))
    geno, mean, inv, op = tk._mma_operands(packed, col, col, b)
    assert geno.shape == (4, 64) and op.shape == (252, 16)
    assert all(t.data_ptr() % 16 == 0 for t in (geno, mean, inv, op))
    assert torch.equal(mean, col) and torch.equal(op[:, :10].float(), tk._round_bf16(b))


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_aligned_rows_pads_with_inert_missing_codes(rng, layout):
    """Rows that are not whole 16-byte copies (63 packed bytes, 252 dense
    samples) or an unaligned base get a padded copy whose extra samples
    standardize to 0, so A^T W of the copy is that of the input plus zero
    rows; aligned rows pass through as they are."""
    g = make_genotypes(rng, 20, 250 if layout == "packed" else 252,
                       missing_rate=0.05)
    geno = _t(js.pack_int8_rows(g) if layout == "packed" else g)
    pad = 0x55 if layout == "packed" else -127
    mu = _t(rng.uniform(0.1, 1.9, (20, 1)).astype(np.float32))
    inv = _t(rng.uniform(0.5, 2.0, (20, 1)).astype(np.float32))
    w = _t(rng.standard_normal((20, 10)).astype(np.float32))
    a = tk.aligned_rows(geno)
    assert a.shape == (20, 64 if layout == "packed" else 256)
    assert torch.equal(a[:, : geno.shape[1]], geno)
    assert bool((a[:, geno.shape[1]:] == pad).all())
    n = tk._samples(geno)
    plain = tk.fused_left_apply_2d_packed_plain
    assert torch.equal(plain(a, mu, inv, w)[:n], plain(geno, mu, inv, w))
    assert not plain(a, mu, inv, w)[n:].any()
    assert tk.aligned_rows(a) is a
    base = torch.zeros(20 * a.shape[1] + 1, dtype=a.dtype)
    shifted = base[1:].view(20, a.shape[1])
    shifted.copy_(a)
    moved = tk.aligned_rows(shifted)
    assert moved.data_ptr() % 16 == 0 and torch.equal(moved, a)


def test_left2d_ab_checks_through_the_wrappers_and_needs_cuda(monkeypatch):
    """The A/B timer of the tensor-core products (kernels 6, 14, 5 and 13,
    `eval/mma2d_ab.py`) holds each product and layout to its plain version
    through the wrappers before it times anything (on the CPU the wrappers
    run the plain versions, so it agrees at its check shapes and a ragged
    one), and exits 1 without a CUDA device."""
    from genomic_pca_tpu_torch.eval import mma2d_ab

    cpu = torch.device("cpu")
    for product, layout in mma2d_ab.NAMES:
        assert mma2d_ab.agrees(product, layout, 70, 256, 10, cpu)
        assert mma2d_ab.agrees(product, layout, *mma2d_ab.CHECKS[product][1], cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mma2d_ab.main(["tag"]) == 1

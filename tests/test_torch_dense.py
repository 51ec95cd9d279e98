"""The port's dense int8 layout against the JAX package, on the CPU.

Kernels 9-12 (`fused_gram_q8`, `fused_gram_apply`, `fused_right_apply`,
`fused_tsq`) and the dense 2-D kernels 13, 14, 7i and 8i
(`fused_right_apply_2d`, `fused_left_apply_2d`, the int8 branches of
`right_apply_2d_q8` / `left_apply_2d_q8`) run their plain versions here
and are held against the JAX kernels in interpret mode at the reference
tests' tolerances; the dense container in both modes (`from_arrays`, the
passes, `left_apply`, `fetch_blocks_device`, `count_missing`, the mode
switch), `prepare_data(packed_pipeline=False)` and EigenSNP on the dense
container are held against the JAX package's.
The CUDA kernels are held against these plain versions on the card in
tests/test_torch_cuda.py.
"""

import dataclasses
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.config import EigenSnpConfig
from genomic_pca_tpu.models import eigensnp as jes
from genomic_pca_tpu.models import pca as jpca
from genomic_pca_tpu.models import prepare as jprep
from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu.ops import standardize as jstd
from genomic_pca_tpu.parallel import sharded as js
from genomic_pca_tpu.parallel.mesh import make_mesh
from genomic_pca_tpu_torch.models import eigensnp as tes
from genomic_pca_tpu_torch.models import pca as tpca
from genomic_pca_tpu_torch.models import prepare as tprep
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.ops.rsvd import quantize_basis
from genomic_pca_tpu_torch.ops import standardize as tstd
from genomic_pca_tpu_torch.parallel import sharded as ts
from tests.conftest import make_genotypes
from tests.test_eigensnp import _setup
from tests.torch_cases import abs_corr, dense_case, exact_pcs, q8_case, quant_model

# bf16: the reference tests' bars (tests/test_packed_kernels.py:38-80): the
# operands round at the same points on both sides, sums run in another
# order, and a sum that flips one bf16 rounding of W moves the result by a
# bf16 ulp of W; tsq's (L, L) entries carry cancellation.  f32: 1e-5
# relative to the largest entry.
BF16_TOL = {"gram": (1e-2, 1e-3), "right": (1e-2, 1e-3), "tsq": (1e-2, 2e-2)}
JAX_FN = {"gram": pk.fused_gram_apply, "right": pk.fused_right_apply,
          "tsq": pk.fused_tsq}
PORT_FN = {"gram": tk.fused_gram_apply, "right": tk.fused_right_apply,
           "tsq": tk.fused_tsq}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _one_device():
    return make_mesh(jax.devices()[:1])


# ---------------------------------------------------------------------------
# Kernels 9-12: plain versions against the JAX kernels.


@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("name", ["gram", "right", "tsq"])
def test_dense_exact_kernel_plain_matches_jax(rng, name, precision):
    geno, mu, inv, b = dense_case(rng)
    ref = np.asarray(JAX_FN[name](
        jnp.asarray(geno), jnp.asarray(mu), jnp.asarray(inv), jnp.asarray(b),
        tile_d=128, precision=precision, interpret=True,
    ))
    tk.reset_launch_counts()
    got = PORT_FN[name](_t(geno), _t(mu), _t(inv), _t(b), precision=precision)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    if precision == "f32":
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5,
                                   atol=1e-5 * np.abs(ref).max())
    else:
        rtol, atol = BF16_TOL[name]
        np.testing.assert_allclose(got.numpy(), ref, rtol=rtol, atol=atol)


def test_dense_bf16_standardization_rounds_as_jax(rng):
    """The plain tile is the JAX bf16 tile bit for bit: two roundings,
    the 0/1 mask; and f32 mode is the f32 tile."""
    geno, mu, inv, _ = dense_case(rng, d=64, n=128)
    for precision, dt in (("bf16", jnp.bfloat16), ("f32", jnp.float32)):
        ref = np.asarray(pk._standardize_tile(
            jnp.asarray(geno), jnp.asarray(mu), jnp.asarray(inv), dt
        )).astype(np.float32)
        got = tk.standardize_dense(_t(geno), _t(mu), _t(inv), precision).numpy()
        np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("d,tile_d", [(512, 128), (300, 64)])
def test_dense_q8_plain_matches_quant_model(rng, d, tile_d):
    """5% missing: the -127 sentinel must enter the integer products as
    raw 0.  A ragged last tile at d = 300."""
    g, iv, u, bq, sb, csum = q8_case(rng, d, 256, 128, missing_rate=0.05)
    out, ru = tk.fused_gram_q8(_t(g), _t(iv), _t(u), _t(bq), _t(sb), _t(csum),
                               tile_d=tile_d)
    ref = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    np.testing.assert_allclose((out - ru).numpy(), ref, rtol=1e-4, atol=1e-2)


def test_dense_q8_plain_matches_jax_kernel_at_equal_tile(rng):
    g, iv, u, bq, sb, csum = q8_case(rng, 512, 256, 128, missing_rate=0.05)
    out_j, ru_j = pk.fused_gram_q8(
        jnp.asarray(g), jnp.asarray(iv), jnp.asarray(u), jnp.asarray(bq),
        jnp.asarray(sb), jnp.asarray(csum), tile_d=128, interpret=True,
    )
    ref = np.asarray(out_j) - np.asarray(ru_j)
    out, ru = tk.fused_gram_q8(_t(g), _t(iv), _t(u), _t(bq), _t(sb), _t(csum),
                               tile_d=128)
    np.testing.assert_allclose((out - ru).numpy(), ref, rtol=1e-4, atol=1e-2)


def test_dense_wrappers_validate(rng):
    geno, mu, inv, b = dense_case(rng, d=16, n=32, ell=4)
    with pytest.raises(ValueError, match="multiple of 4"):
        tk.fused_right_apply(_t(geno[:, :30]), _t(mu), _t(inv), _t(b[:30]))
    with pytest.raises(TypeError):
        tk.fused_gram_apply_packed(_t(geno), _t(mu), _t(inv), _t(b))
    with pytest.raises(TypeError):
        tk.fused_tsq(_t(geno.view(np.uint8)), _t(mu), _t(inv), _t(b))
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.fused_right_apply(_t(geno).to("meta"), _t(mu).to("meta"),
                             _t(inv).to("meta"), _t(b).to("meta"))
    with pytest.raises(ValueError, match="tile_d"):
        tk.fused_gram_q8(_t(geno), _t(inv), _t(inv), _t(b).to(torch.int8),
                         torch.ones((1, 1)), torch.zeros((1, 4)), tile_d=100)


# ---------------------------------------------------------------------------
# The dense 2-D kernels 13, 14, 7i and 8i: plain versions against the JAX
# kernels in interpret mode.  Dense 2-D arrays are in original sample
# order on both sides (the plane-major permutation is packed only).

# (rtol, atol) of tests/test_torch_wide.py for kernels 5-8, the reference's
# own 2-D tests' bars (tests/test_packed_kernels.py:289-321) for bf16; f32
# differs only in the order of f32 sums.
TOL_2D = {"f32": (1e-4, 1e-4), "bf16": (1e-2, 1e-3)}


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_dense_right_2d_plain_matches_jax(rng, precision):
    """Kernel 13 on 5%-missing int8 with an inert row, two sample tiles:
    W in f32, not rounded."""
    geno, mu, inv, b = dense_case(rng, d=64, n=512)
    ref = np.asarray(pk.fused_right_apply_2d(
        jnp.asarray(geno), jnp.asarray(mu), jnp.asarray(inv), jnp.asarray(b),
        tile_d=32, tile_n=256, precision=precision, interpret=True,
    ))
    tk.reset_launch_counts()
    got = tk.fused_right_apply_2d(_t(geno), _t(mu), _t(inv), _t(b),
                                  precision=precision)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    np.testing.assert_allclose(got.numpy(), ref, *TOL_2D[precision])


@pytest.mark.parametrize("ell", [10, 130])
@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_dense_right_2d_plain_matches_jax_at_hard_cases(rng, precision, ell):
    """Kernel 13's plain version, which tests/test_torch_cuda.py holds the
    tensor-core kernel to, against the JAX kernel at the GPU test's hard
    cases the reference's tiling admits: L = 10 and 130, 5% missing, an
    inert row, and 2% of dosages outside {0, 1, 2} (the dense bf16 tile
    rounds g * scale before the shift: odd dosages make that rounding
    inexact)."""
    geno, mu, inv, _ = dense_case(rng, d=96, n=512)
    odd = rng.random(geno.shape) < 0.02
    geno[odd] = rng.integers(-100, 100, size=int(odd.sum()))
    b = (rng.standard_normal((512, ell)) / np.sqrt(512)).astype(np.float32)
    ref = np.asarray(pk.fused_right_apply_2d(
        jnp.asarray(geno), jnp.asarray(mu), jnp.asarray(inv), jnp.asarray(b),
        tile_d=32, tile_n=256, precision=precision, interpret=True,
    ))
    tk.reset_launch_counts()
    got = tk.fused_right_apply_2d(_t(geno), _t(mu), _t(inv), _t(b),
                                  precision=precision)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert not got[5].any()
    np.testing.assert_allclose(got.numpy(), ref, *TOL_2D[precision])


@pytest.mark.parametrize("precision", ["f32", "bf16"])
def test_dense_left_2d_plain_matches_jax(rng, precision):
    """Kernel 14: W (D, L) f32, not bf16-exact, rounded to bf16 on load in
    bf16 mode on both sides."""
    geno, mu, inv, b = dense_case(rng, d=64, n=512)
    w = (b[:64] * 3.0).astype(np.float32)
    ref = np.asarray(pk.fused_left_apply_2d(
        jnp.asarray(geno), jnp.asarray(mu), jnp.asarray(inv), jnp.asarray(w),
        tile_d=32, tile_n=256, precision=precision, interpret=True,
    ))
    got = tk.fused_left_apply_2d(_t(geno), _t(mu), _t(inv), _t(w),
                                 precision=precision)
    np.testing.assert_allclose(got.numpy(), ref, *TOL_2D[precision])


def test_dense_right_2d_q8_plain_is_the_exact_integer_product(rng):
    """Kernel 7i's plain version equals the JAX kernel's int8 branch and
    the int64 product bit for bit (integer sums below 2^24): the -127
    sentinel enters as raw 0."""
    g, _, _, bq, _, _ = q8_case(rng, 64, 512, 128, missing_rate=0.05)
    ref = np.asarray(pk.right_apply_2d_q8(
        jnp.asarray(g), jnp.asarray(bq), tile_d=32, tile_n=256, interpret=True,
    ))
    tk.reset_launch_counts()
    got = tk.right_apply_2d_q8(_t(g), _t(bq)).numpy()
    assert all(v == 0 for v in tk.LAUNCHES.values())
    exact = np.maximum(g, 0).astype(np.int64) @ bq.astype(np.int64)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, exact.astype(np.float32))


def test_dense_left_2d_q8_plain_matches_jax_and_replay(rng):
    """Kernel 8i's plain version against the JAX kernel's int8 branch on
    the same z8 and scales, and against a float64 replay: only the f32 sum
    over row tiles differs (rtol 1e-5, kernel 8's bar)."""
    d, n, ell, tile_d = 128, 512, 128, 32
    g = make_genotypes(rng, d, n, missing_rate=0.05)
    z8 = rng.integers(-127, 128, size=(d, ell)).astype(np.int8)
    sz = rng.uniform(0.01, 0.1, size=d // tile_d).astype(np.float32)
    ref = np.asarray(pk.left_apply_2d_q8(
        jnp.asarray(g), jnp.asarray(z8), jnp.asarray(sz), tile_d=tile_d,
        tile_n=256, interpret=True,
    ))
    got = tk.left_apply_2d_q8(_t(g), _t(z8), _t(sz), tile_d).numpy()
    g0 = np.maximum(g, 0).astype(np.float64)
    replay = sum(g0[lo:lo + tile_d].T @ z8[lo:lo + tile_d].astype(np.float64)
                 * float(sz[lo // tile_d]) for lo in range(0, d, tile_d))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got, replay, rtol=1e-5, atol=1e-5)


def test_dense_q8_power_pass_2d_matches_jax_and_quant_model(rng):
    """The dense 2-D q8 pass (7i, torch glue, 8i) against the JAX pass at
    an equal tile and against the float64 quantization model (the bar of
    tests/test_q8.py:156-175); the dense 1-D plain pass is the same
    model."""
    d, n, ell, tile_d = 256, 512, 128, 128
    g, iv, u, bq, sb, csum = q8_case(rng, d, n, ell, missing_rate=0.05)
    out_j, ru_j = pk.q8_power_pass_2d(
        jnp.asarray(g), jnp.asarray(iv), jnp.asarray(u), jnp.asarray(bq),
        jnp.asarray(sb), jnp.asarray(csum), tile_d=tile_d, tile_n=256,
        interpret=True,
    )
    ref = np.asarray(out_j) - np.asarray(ru_j)
    out, ru = tk.q8_power_pass_2d(_t(g), _t(iv), _t(u), _t(bq), _t(sb),
                                  _t(csum), tile_d=tile_d)
    np.testing.assert_allclose((out - ru).numpy(), ref, rtol=1e-4, atol=1e-2)
    model = quant_model(g, iv, u, bq, float(sb[0, 0]), tile_d)
    np.testing.assert_allclose((out - ru).numpy(), model, rtol=1e-4, atol=1e-2)
    out1, ru1 = tk.fused_gram_q8(_t(g), _t(iv), _t(u), _t(bq), _t(sb), _t(csum),
                                 tile_d=tile_d)
    np.testing.assert_array_equal((out1 - ru1).numpy(), (out - ru).numpy())


def test_dense_2d_wrappers_validate_and_route(rng):
    geno, mu, inv, b = dense_case(rng, d=16, n=32, ell=4)
    with pytest.raises(ValueError, match="multiple of 4"):
        tk.fused_left_apply_2d(_t(geno[:, :30]), _t(mu), _t(inv), _t(b[:16]))
    with pytest.raises(TypeError):
        tk.fused_right_apply_2d(_t(geno.view(np.uint8)), _t(mu), _t(inv), _t(b))
    with pytest.raises(ValueError, match="b must be"):
        tk.fused_right_apply_2d(_t(geno), _t(mu), _t(inv), _t(b[:16]))
    tk.reset_launch_counts()
    for precision in ("bf16", "f32"):
        assert tk.fused_right_apply_2d(_t(geno), _t(mu), _t(inv), _t(b),
                                       precision=precision).shape == (16, 4)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    with pytest.raises(TypeError, match="uint8 \\(packed\\) or int8"):
        tk.right_apply_2d_q8(_t(geno).to(torch.int16), _t(b).to(torch.int8))
    with pytest.raises(ValueError, match="bq must be"):
        tk.right_apply_2d_q8(_t(geno), _t(b[:16]).to(torch.int8))
    with pytest.raises(ValueError, match="no kernel for device"):
        tk.left_apply_2d_q8(_t(geno).to("meta"),
                            torch.zeros((16, 4), dtype=torch.int8, device="meta"),
                            torch.ones(1, device="meta"), 16)


def test_standardize_module_matches_jax(rng):
    g = make_genotypes(rng, 40, 33, missing_rate=0.1)
    mean = rng.uniform(0, 2, 40).astype(np.float32)
    std = rng.uniform(0, 1, 40).astype(np.float32)
    std[[3, 9]] = 0.0
    inv_j = np.asarray(jstd.inv_std_from_std(std))
    inv_t = tstd.inv_std_from_std(std).numpy()
    np.testing.assert_array_equal(inv_t, inv_j)
    ref = np.asarray(jstd.standardize_strip(jnp.asarray(g), jnp.asarray(mean),
                                            jnp.asarray(inv_j)))
    got = tstd.standardize_strip(_t(g), _t(mean), _t(inv_t)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(
        tstd.standardize_rows(_t(g), _t(mean), _t(inv_t)).numpy(), got)


# ---------------------------------------------------------------------------
# The container's constructors.


@pytest.mark.parametrize("moments", ["given", "host", "center_only"])
def test_from_arrays_holds_reference_arrays(rng, moments):
    d, n = 300, 37
    g = make_genotypes(rng, d, n, missing_rate=0.05)
    g[7] = 1  # monomorphic: std 0 -> inert
    strips = [g[:128], g[128:]]
    kw = {}
    if moments == "given":
        mean, std = ts.host_moments(g)
        std[4] = 0.0
        kw = dict(means=[mean[:128], mean[128:]], stds=[std[:128], std[128:]])
    elif moments == "center_only":
        kw = dict(center_only=True)
    sm_j = js.ShardedMatrix.from_arrays(iter(strips), mesh=_one_device(),
                                        mode="xla", tile_d=128, **kw)
    sm_t = ts.ShardedMatrix.from_arrays(iter(strips), device="cpu", **kw)
    assert not sm_t.packed and sm_t.geno.dtype == torch.int8
    assert (sm_t.n_rows, sm_t.n_samples, sm_t.n_pad, sm_t.d_pad) == (d, n, 128, d)
    assert sm_t.n_pad == sm_j.n_pad
    np.testing.assert_array_equal(sm_t.geno.numpy(), np.asarray(sm_j.geno)[:d])
    np.testing.assert_array_equal(sm_t.mean.numpy(), np.asarray(sm_j.mean)[:d])
    np.testing.assert_array_equal(sm_t.inv_std.numpy(),
                                  np.asarray(sm_j.inv_std)[:d])
    assert np.all(sm_t.geno.numpy()[:, n:] == -127)


def test_from_reference_arrays_adopts_a_dense_container(rng):
    """The JAX container's padded rows (inv_std 0, all missing) come
    across verbatim and stay inert."""
    g = make_genotypes(rng, 300, 37, missing_rate=0.05)
    sm_j = js.ShardedMatrix.from_arrays(iter([g]), mesh=make_mesh(), mode="xla",
                                        tile_d=128)
    arrays = [np.asarray(x) for x in (sm_j.geno, sm_j.mean, sm_j.inv_std)]
    sm_t = ts.ShardedMatrix.from_reference_arrays(*arrays, 300, 37, "cpu",
                                                  kernel_precision="f32")
    assert sm_t.d_pad == arrays[0].shape[0] > 300 and not sm_t.packed
    for got, ref in zip((sm_t.geno, sm_t.mean, sm_t.inv_std), arrays):
        np.testing.assert_array_equal(got.numpy(), ref)
    sm_a = ts.ShardedMatrix.from_arrays(iter([g]), device="cpu",
                                        kernel_precision="f32")
    b = torch.from_numpy(rng.standard_normal((37, 6)).astype(np.float32))
    np.testing.assert_allclose(sm_t.gram_apply(b).numpy(),
                               sm_a.gram_apply(b).numpy(), rtol=1e-5, atol=1e-4)
    with pytest.raises(TypeError):
        ts.ShardedMatrix.from_reference_arrays(arrays[0].astype(np.int16),
                                               *arrays[1:], 300, 37, "cpu")


# ---------------------------------------------------------------------------
# The container's passes against the JAX container.


def _dense_pair(rng, mode, precision, d=500, n=70, n_pops=3, fst=0.2, tile_d=128):
    g = make_genotypes(rng, d, n, missing_rate=0.02, n_pops=n_pops, fst=fst)
    mean, std = ts.host_moments(g)
    sm_j = js.ShardedMatrix.from_arrays(
        iter([g]), means=[mean], stds=[std], mesh=_one_device(), mode=mode,
        tile_d=tile_d, kernel_precision=precision,
    )
    sm_t = ts.ShardedMatrix.from_reference_arrays(
        np.asarray(sm_j.geno), np.asarray(sm_j.mean), np.asarray(sm_j.inv_std),
        d, n, "cpu", tile_d=sm_j.tile_d, kernel_precision=precision,
    )
    return g, sm_j, sm_t


@pytest.mark.parametrize("mode,precision", [("xla", "f32"),
                                            ("pallas_interpret", "bf16")])
@pytest.mark.parametrize("name", ["gram_apply", "tsq_accumulate", "right_apply"])
def test_dense_passes_match_reference(rng, name, mode, precision):
    _, sm_j, sm_t = _dense_pair(rng, mode, precision)
    b = np.random.default_rng(5).standard_normal((70, 9)).astype(np.float32)
    b /= np.sqrt(70)
    ref = np.asarray(getattr(sm_j, name)(jnp.asarray(b)))
    got = getattr(sm_t, name)(torch.from_numpy(b))
    got = got if isinstance(got, np.ndarray) else got.numpy()
    if precision == "f32":
        rtol, atol = 1e-4, 1e-4
    else:
        rtol, atol = BF16_TOL[{"gram_apply": "gram", "tsq_accumulate": "tsq",
                               "right_apply": "right"}[name]]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


@pytest.mark.parametrize("mode", ["xla", "pallas_interpret"])
def test_dense_left_apply_matches_reference(rng, mode):
    _, sm_j, sm_t = _dense_pair(rng, mode, "q8")
    w = rng.standard_normal((500, 5)).astype(np.float32)
    np.testing.assert_allclose(sm_t.left_apply(w), sm_j.left_apply(w),
                               rtol=2e-5, atol=2e-4)
    with pytest.raises(ValueError, match="left_apply expects"):
        sm_t.left_apply(w[:10])


# q8: any f32-level difference in z can flip one 8-bit rounding; the
# reference's own q8 test holds eigenvalues to 5e-3 (tests/test_q8.py).
@pytest.mark.parametrize("mode,precision,s_rtol", [
    ("xla", "f32", 1e-4), ("pallas_interpret", "q8", 5e-3),
])
def test_dense_power_iterate_and_pca_core_match_reference(rng, mode, precision,
                                                          s_rtol):
    _, sm_j, sm_t = _dense_pair(rng, mode, precision, n_pops=4)
    b0 = np.random.default_rng(6).standard_normal((70, 8)).astype(np.float32)
    # The port holds its basis orthogonal to the ones vector from the
    # sketch on (ops/rsvd.centre_samples, DEVIATIONS.md): both loops start
    # from the sketch so centred.
    b0 -= b0.mean(axis=0)
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


def test_dense_and_packed_containers_agree(rng):
    """The same genotypes in both layouts: the same standardized operator,
    bf16 operands rounded at the same points (dosages {0, 1, 2} make the
    dense layout's extra rounding exact)."""
    g = make_genotypes(rng, 400, 90, missing_rate=0.03)
    mean, std = ts.host_moments(g)
    sm_d = ts.ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                        device="cpu")
    sm_p = ts.ShardedMatrix.from_packed_rows(ts.pack_int8_rows(g), mean, std, 90,
                                             "cpu")
    b = torch.from_numpy(rng.standard_normal((90, 7)).astype(np.float32))
    for name in ("gram_apply", "tsq_accumulate"):
        np.testing.assert_allclose(getattr(sm_d, name)(b).numpy(),
                                   getattr(sm_p, name)(b).numpy(),
                                   rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(sm_d.right_apply(b), sm_p.right_apply(b),
                               rtol=1e-5, atol=1e-4)
    assert sm_d.count_missing() == sm_p.count_missing() == int((g == -127).sum())


# ---------------------------------------------------------------------------
# Mode switch.


@pytest.mark.parametrize("precision,last_1d,first_2d", [
    ("q8", 11_008, 11_136), ("bf16", 11_008, 11_136), ("f32", 8_704, 8_832),
])
def test_dense_mode_switch_matches_auto_tile_d(precision, last_1d, first_2d):
    assert js.auto_tile_d(last_1d, precision=precision) > 0
    assert js.auto_tile_d(first_2d, precision=precision) == 0
    for n_pad in range(128, 13_000, 128):
        wide = js.auto_tile_d(n_pad, precision=precision) == 0
        assert (ts.default_mode(n_pad, precision, packed=False) == "2d") == wide
    assert ts.default_mode(last_1d, precision, packed=False) == "1d"
    assert ts.default_mode(first_2d, precision, packed=False) == "2d"


def test_dense_2d_container_refuses_passes_but_projects(rng):
    """A dense container at the 2-D width (11,100 samples, n_pad 11,136)
    picks mode "2d" and runs every pass through the dense 2-D kernels'
    plain versions: gram, tsq and right against the JAX dense container
    in mode "pallas2d_interpret" holding the same arrays (f32; the bars of
    tests/test_torch_wide.py's 2-D container test), the q8 pass against
    the JAX 2-D q8 pass at the same tile, and the projection against a
    float64 transform."""
    g = make_genotypes(rng, 24, 11_100, missing_rate=0.02)
    mean, std = ts.host_moments(g)
    sm_j = js.ShardedMatrix.from_arrays(
        iter([g]), means=[mean], stds=[std], mesh=_one_device(),
        mode="pallas2d_interpret", tile_d=64, kernel_precision="f32")
    sm = ts.ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                      device="cpu", kernel_precision="f32",
                                      tile_d=64)
    assert sm.n_pad == sm_j.n_pad == 11_136 and sm.mode == "2d"
    assert ts.ShardedMatrix.from_arrays(iter([g]), device="cpu").mode == "2d"
    b = np.random.default_rng(2).standard_normal((11_100, 4)).astype(np.float32)
    b /= np.sqrt(11_100)
    for name, atol in (("gram_apply", 1e-2), ("tsq_accumulate", 1e-1),
                       ("right_apply", 1e-2)):
        ref = np.asarray(getattr(sm_j, name)(jnp.asarray(b)))
        got = getattr(sm, name)(torch.from_numpy(b))
        got = got if isinstance(got, np.ndarray) else got.numpy()
        np.testing.assert_allclose(got, ref, rtol=1e-4, atol=atol, err_msg=name)
    geno_j = np.asarray(sm_j.geno)
    iv_j = np.asarray(sm_j.inv_std)
    u_j = np.asarray(sm_j.mean) * iv_j
    bq, sb, csum = (x.numpy() for x in quantize_basis(sm.basis(b)))
    out_j, ru_j = pk.q8_power_pass_2d(
        jnp.asarray(geno_j), jnp.asarray(iv_j), jnp.asarray(u_j), jnp.asarray(bq),
        jnp.asarray(sb), jnp.asarray(csum), tile_d=64, tile_n=sm_j.tile_n,
        interpret=True)
    ref = (np.asarray(out_j) - np.asarray(ru_j))[:11_100]
    tk.reset_launch_counts()
    got = sm._gram_q8(sm.basis(b))[:11_100].numpy()
    assert all(v == 0 for v in tk.LAUNCHES.values())
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-2)
    w = rng.standard_normal((24, 3)).astype(np.float32)
    valid = g != -127
    inv = ts.inv_std_of(std)
    a = np.where(valid, (g - mean[:, None].astype(np.float64)) * inv[:, None], 0.0)
    np.testing.assert_allclose(sm.left_apply(w), a.T @ w, rtol=2e-5, atol=2e-4)
    assert sm.count_missing() == int((~valid).sum())


@pytest.mark.parametrize("precision", ["bf16", "q8"])
def test_dense_2d_container_matches_reference(rng, precision):
    """The dense 2-D container against the JAX dense container in mode
    "pallas2d_interpret" on the same arrays: the exact passes in bf16 (the
    kernels' bf16 bars), and in q8 `streamed_pca` per-PC |r| > 0.999
    against the JAX run and the float64 oracle (tests/test_q8.py:178-193)."""
    d, n, k = 1024, 192, 4
    g = make_genotypes(np.random.default_rng(0), d, n, missing_rate=0.02,
                       n_pops=5, fst=0.2)  # 4 PCs separated by 5% eigengaps
    mean, std = ts.host_moments(g)
    sm_j = js.ShardedMatrix.from_arrays(
        iter([g]), means=[mean], stds=[std], mesh=_one_device(),
        mode="pallas2d_interpret", tile_d=128, kernel_precision=precision)
    sm_t = ts.ShardedMatrix.from_reference_arrays(
        np.asarray(sm_j.geno), np.asarray(sm_j.mean), np.asarray(sm_j.inv_std),
        d, n, "cpu", tile_d=sm_j.tile_d, kernel_precision=precision, mode="2d")
    assert not sm_t.packed and sm_t.mode == "2d"
    if precision == "bf16":
        b = np.random.default_rng(5).standard_normal((n, 9)).astype(np.float32)
        b /= np.sqrt(n)
        for name, key in (("gram_apply", "gram"), ("tsq_accumulate", "tsq"),
                          ("right_apply", "right")):
            ref = np.asarray(getattr(sm_j, name)(jnp.asarray(b)))
            got = getattr(sm_t, name)(torch.from_numpy(b))
            got = got if isinstance(got, np.ndarray) else got.numpy()
            np.testing.assert_allclose(got, ref, *BF16_TOL[key], err_msg=name)
        return
    v_true, evals, _, _ = exact_pcs(g, k + 1)
    sep = next((j for j in range(k) if (evals[j] - evals[j + 1]) / evals[j] < 0.05), k)
    assert sep >= 3
    res_j = jpca.streamed_pca(sm_j, k=k, n_power_iter=6, seed=11)
    res_t = tpca.streamed_pca(sm_t, k=k, n_power_iter=6, seed=11)
    for j in range(sep):
        assert abs_corr(res_t.scores[:, j], res_j.scores[:, j]) > 0.999, j
        assert abs_corr(res_t.scores[:, j], v_true[:, j]) > 0.999, j


# ---------------------------------------------------------------------------
# Device block slicing.


def test_dense_fetch_blocks_match_reference(rng):
    """Blocks that end inside the matrix (the reference moves a window
    that would pass the last row: ROADMAP Queue 3)."""
    _, sm_j, sm_t = _dense_pair(rng, "xla", "f32")
    starts = np.array([0, 50, 200])
    lens = np.array([50, 64, 100])
    args = (sm_j.geno, sm_j.mean, sm_j.inv_std, jnp.asarray(starts, jnp.int32),
            jnp.asarray(lens, jnp.int32))
    ref = np.asarray(js._slice_blocks_impl(*args, None, 128))
    got = sm_t.fetch_blocks_device(starts, lens, 128).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    cols = np.array([3, 9, 11, 40, 69])
    ref = np.asarray(js._slice_blocks_impl(*args, jnp.asarray(cols, jnp.int32), 128))
    got = sm_t.fetch_blocks_device(starts, lens, 128, torch.from_numpy(cols)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-6, atol=1e-6)
    assert sm_t.count_missing() == sm_j.count_missing() > 0


# ---------------------------------------------------------------------------
# prepare_data(packed_pipeline=False) and EigenSNP on the dense container.


@pytest.mark.parametrize("keep_list", [False, True])
def test_prepare_dense_bit_identical_to_reference(tmp_path, rng, caplog, keep_list):
    """The port's device QC scan and capture against the JAX ones
    (qc_mode "auto" with packed_pipeline=False): the same decisions and
    moments, and the same int8 bytes in the loaded container."""
    _, _, cfg = _setup(tmp_path, rng, n_snps=400, n_samples=50, missing_rate=0.05)
    cfg = dataclasses.replace(cfg, packed_pipeline=False)
    if keep_list:
        keep = tmp_path / "keep.txt"
        keep.write_text("".join(f"sample{i}\n" for i in range(0, 50, 3)))
        cfg = dataclasses.replace(cfg, sample_keep_path=str(keep))
    with caplog.at_level(logging.INFO, logger="genomic_pca_tpu_torch"):
        pt = tprep.prepare_data(cfg, device="cpu")
    assert "SNP QC: device int8 scan on cpu" in caplog.text
    pj = jprep.prepare_data(cfg)
    np.testing.assert_array_equal(pt.qc_sample_indices, pj.qc_sample_indices)
    np.testing.assert_array_equal(pt.pca_snp_orig_indices, pj.pca_snp_orig_indices)
    for a in ("mean", "std"):
        assert getattr(pt, a).dtype == getattr(pj, a).dtype
        np.testing.assert_array_equal(getattr(pt, a), getattr(pj, a))
    assert pt.estimate_resident_bytes() == pj.estimate_resident_bytes()
    sm_t, sm_j = pt.load_matrix("cpu", strip_size=128), pj.load_matrix()
    d = pt.n_pca_snps
    assert not sm_t.packed and not sm_j.packed and sm_t.n_pad == sm_j.n_pad
    np.testing.assert_array_equal(sm_t.geno.numpy(), np.asarray(sm_j.geno)[:d])
    np.testing.assert_array_equal(sm_t.mean.numpy(), np.asarray(sm_j.mean)[:d])
    np.testing.assert_array_equal(sm_t.inv_std.numpy(), np.asarray(sm_j.inv_std)[:d])


def test_prepare_dense_missing_policy_error(tmp_path, rng):
    from genomic_pca_tpu_torch.errors import DataPrepError

    _, _, cfg = _setup(tmp_path, rng, n_snps=200, n_samples=30, missing_rate=0.05)
    cfg = dataclasses.replace(cfg, packed_pipeline=False, missing_policy="error")
    with pytest.raises(DataPrepError, match="missing_policy"):
        tprep.prepare_data(cfg, device="cpu").load_matrix("cpu")


def test_eigensnp_on_the_dense_container(tmp_path, rng):
    """Against the JAX package with packed_pipeline=False (per-PC |r| over
    the separated prefix) and against the port's packed run (the same
    standardized operator: tests/test_eigensnp.py's gram_apply bar)."""
    g, _, cfg = _setup(tmp_path, rng, n_snps=800, n_samples=100, n_pops=8, fst=0.25)
    algo = EigenSnpConfig(k_global=5, components_per_block=12, subset_factor=1.0,
                          min_subset_size=10, max_subset_size=100_000,
                          refine_passes=2, seed=2025, snp_strip_size=200)
    dense = dataclasses.replace(cfg, packed_pipeline=False)
    pt = tprep.prepare_data(dense, device="cpu")
    res = tes.compute_eigensnp_pca(pt, algo, device="cpu")
    ref = jes.compute_eigensnp_pca(jprep.prepare_data(dense), algo)
    raw = pt.bed.read(pt.pca_snp_orig_indices, pt.qc_sample_indices)
    _, evals, _, _ = exact_pcs(raw, 6)
    sep = next((j for j in range(5) if (evals[j] - evals[j + 1]) / evals[j] < 0.05), 5)
    assert sep >= 2
    for j in range(sep):
        assert abs_corr(res.scores[:, j], ref.scores[:, j]) > 0.999, j
        assert abs_corr(res.loadings[:, j], ref.loadings[:, j]) > 0.999, j
    sm_d, sm_p = pt.load_matrix("cpu"), tprep.prepare_data(cfg).load_matrix("cpu")
    assert not sm_d.packed and sm_p.packed
    b0 = torch.from_numpy(rng.standard_normal((100, 4)).astype(np.float32))
    np.testing.assert_allclose(sm_d.gram_apply(b0).numpy(),
                               sm_p.gram_apply(b0).numpy(), rtol=1e-4, atol=1e-3)

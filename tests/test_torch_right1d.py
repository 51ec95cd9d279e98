"""The 1-D right products A B (kernels 4 and 11) of the port against the
JAX package's.

On a CUDA tensor a bf16 call launches right_narrow_mma_kernel for B of at
most 16 columns (the loadings), which reads B in the sample order of its
register fragments (`right_narrow_operand`), and right2d_mma_kernel's f32
store for wider B; f32 mode keeps the FMA loop (`right1d_route`).  Here,
on the CPU, the wrappers run the plain versions: they must match the JAX
`fused_right_apply_packed` / `fused_right_apply` in interpret mode at the
reference tests' bars, and the permuted operand must leave A B unchanged.
The card's side is `tests/test_torch_cuda.py`.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from genomic_pca_tpu.ops import pallas_kernels as pk
from genomic_pca_tpu_torch.ops import build
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows
from tests.conftest import make_genotypes

# (rows, samples): rows not a multiple of the JAX row tile, past one
# 1,024-sample fold; samples not a multiple of 4 (301), 16 (1,030) or 128.
SHAPES = [(1100, 301), (700, 1030)]
ELLS = [1, 10, 16, 17, 128]
# The reference's bars (tests/test_packed_kernels.py): bf16 operands
# rounded at the same points on both sides, f32 sums in another order.
TOL = {"bf16": (1e-2, 1e-3), "f32": (1e-5, 1e-5)}
RIGHT = {"packed": tk.fused_right_apply_packed, "dense": tk.fused_right_apply}
JAX_TILE = 512
# The samples of a chunk in each layout: 128 bytes of a row.
CHUNKS = {"packed": 512, "dense": 128}


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _case(seed, layout, d, n, ell):
    """(genotypes as the port takes them, mean (d, 1), inv_std (d, 1), b):
    1% missing, an inert row, dense dosages outside {0, 1, 2} and its rows
    padded with -127 to a multiple of 4 samples; b over the padded
    samples (packed: 4 * ceil(n / 4))."""
    rng = np.random.default_rng(seed)
    g = make_genotypes(rng, d, n, missing_rate=0.01)
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
    b = (rng.standard_normal((4 * -(-n // 4), ell)) / np.sqrt(n)).astype(np.float32)
    return geno, mu, inv, b


def _jax(layout, geno, mu, inv, b, precision):
    """A B of the JAX right kernel of the layout in interpret mode, on rows
    padded with inert missing codes to a multiple of its row tile; packed
    B in plane-major order (the rows of A B do not depend on it)."""
    d = geno.shape[0]
    pad = -d % JAX_TILE
    fill = 0x55 if layout == "packed" else -127
    geno = np.concatenate([geno, np.full((pad, geno.shape[1]), fill, geno.dtype)])
    mu = np.concatenate([mu, np.zeros((pad, 1), np.float32)])
    inv = np.concatenate([inv, np.zeros((pad, 1), np.float32)])
    args = [jnp.asarray(x) for x in (geno, mu, inv)]
    kw = {"tile_d": JAX_TILE, "precision": precision, "interpret": True}
    if layout == "dense":
        return np.asarray(pk.fused_right_apply(*args, jnp.asarray(b), **kw))[:d]
    perm = pk.plane_major_perm(b.shape[0])
    return np.asarray(pk.fused_right_apply_packed(*args, jnp.asarray(b[perm]),
                                                  **kw))[:d]


@pytest.mark.parametrize("ell", ELLS)
@pytest.mark.parametrize("d,n", SHAPES)
@pytest.mark.parametrize("precision", ["f32", "bf16"])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_matches_jax_kernel(layout, precision, d, n, ell):
    """The port's right wrapper (plain version on the CPU) against the JAX
    kernel of the same layout in interpret mode, at the reference tests'
    bars: L at, below and past the narrow kernel's 16 columns and at the
    streamed tsq pass's 128; ragged rows and samples."""
    geno, mu, inv, b = _case(d + ell, layout, d, n, ell)
    ref = _jax(layout, geno, mu, inv, b, precision)
    got = RIGHT[layout](_t(geno), _t(mu), _t(inv), _t(b), precision=precision).numpy()
    assert got.shape == (d, ell)
    rtol, atol = TOL[precision]
    np.testing.assert_allclose(got, ref, rtol=rtol, atol=atol)


def _operand_order(chunk, n_pad):
    """For each K step of the narrow operand and each K slot kk (0..15),
    the sample it holds: chunk s, step m, slot kk = (q, p) with q = kk % 8
    // 2, p = kk % 2 + 2 (kk // 8) holds sample s chunk + (chunk / 4) q +
    4 m + p.  (steps, 16) int."""
    kk = np.arange(16)
    q, p = kk % 8 // 2, kk % 2 + 2 * (kk // 8)
    steps = np.arange(n_pad // 16)
    s, m = steps // (chunk // 16), steps % (chunk // 16)
    return (s * chunk)[:, None] + (chunk // 4) * q[None] + 4 * m[:, None] + p[None]


def _unpermute(op):
    """The narrow operand (blocks, steps, 256) as (blocks, steps, kk 16,
    column 16): element nh 128 + kh 64 + n8 8 + kl of a step is slot kk =
    8 kh + kl, column 8 nh + n8."""
    blocks, steps = op.shape[:2]
    x = op.float().reshape(blocks, steps, 2, 2, 8, 8)  # nh, kh, n8, kl
    return x.permute(0, 1, 3, 5, 2, 4).reshape(blocks, steps, 16, 16)


@pytest.mark.parametrize("ell", [1, 10, 16, 17, 40])
@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_narrow_operand_order(layout, ell):
    """The narrow operand holds every sample of its chunks once, in the
    fragment order `_operand_order` states, rounded to bf16 once; columns
    >= L and samples past N (up to whole chunks of the rows' width) are
    zero; and A B is unchanged when A's columns take the same order."""
    chunk = CHUNKS[layout]
    rng = np.random.default_rng(ell)
    n, samples = 1030, 1100  # B's samples, and the rows' wider width
    b = _t(rng.standard_normal((n, ell)).astype(np.float32))
    op = tk.right_narrow_operand(b, chunk, samples)
    n_pad = -(-samples // chunk) * chunk
    blocks = -(-ell // 16)
    assert op.dtype == torch.bfloat16
    assert tuple(op.shape) == (blocks, n_pad // 16, 256)
    order = _operand_order(chunk, n_pad)
    assert sorted(order.ravel().tolist()) == list(range(n_pad))
    full = torch.zeros((n_pad, 16 * blocks))
    full[:n, :ell] = tk._round_bf16(b)
    want = full[torch.from_numpy(order)].reshape(n_pad // 16, 16, blocks, 16)
    got = _unpermute(op)
    assert torch.equal(got, want.permute(2, 0, 1, 3))
    assert not got.permute(1, 2, 0, 3).reshape(-1, 16 * blocks)[:, ell:].any()
    a = _t(rng.standard_normal((5, n_pad)).astype(np.float32)).double()
    a_perm = a[:, torch.from_numpy(order).reshape(-1)].reshape(5, -1, 16)
    prod = torch.einsum("dsk,csko->dco", a_perm, got.double()).reshape(5, -1)
    np.testing.assert_allclose(prod[:, :ell].numpy(),
                               (a[:, :n] @ full[:n, :ell].double()).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_right1d_route_is_a_function_of_the_width_and_precision():
    """bf16 calls of at most NARROW_MAX_L = 16 columns take the narrow
    kernel, wider ones the 2-D right product's f32 store; f32 calls the
    FMA loop at every width; another precision raises."""
    assert tk.NARROW_MAX_L == 16
    for ell in (1, 3, 10, 16):
        assert tk.right1d_route(ell, "bf16") == "narrow"
    for ell in (17, 32, 128, 256):
        assert tk.right1d_route(ell, "bf16") == "wide"
    for ell in (1, 10, 17, 128):
        assert tk.right1d_route(ell, "f32") == "fma"
    with pytest.raises(ValueError, match="precision"):
        tk.right1d_route(10, "fp8")


@pytest.mark.parametrize("layout", ["packed", "dense"])
def test_right_on_a_cpu_tensor_runs_plain_and_counts_no_launch(layout):
    geno, mu, inv, b = (_t(x) for x in _case(3, layout, 300, 64, 10))
    tk.reset_launch_counts()
    got = RIGHT[layout](geno, mu, inv, b)
    assert all(v == 0 for v in tk.LAUNCHES.values())
    assert torch.equal(got, tk.PLAIN[RIGHT[layout].__name__](geno, mu, inv, b, "bf16"))


@pytest.mark.parametrize("sms", [None, 132])
def test_right_narrow_plan_without_cuda_raises_as_right2d_plan_does(monkeypatch,
                                                                    tmp_path, sms):
    """The plan is read from the built kernel library: without CUDA (no
    device for the SM count, no nvcc to build with) `right_narrow_plan`
    raises the error `right2d_plan` raises, and reports no plan."""
    monkeypatch.setattr(build, "BUILD_ROOT", tmp_path)
    errors = []
    for plan in (lambda: tk.right2d_plan(262_144, 2_048, 10, sms),
                 lambda: tk.right_narrow_plan(262_144, 2_048, 10, torch.uint8, sms)):
        with pytest.raises(Exception) as info:
            plan()
        errors.append((type(info.value), str(info.value)))
    assert errors[0] == errors[1]


def test_mma2d_ab_right1d_checks_through_the_wrappers_and_needs_cuda(monkeypatch):
    """The A/B timer's right1d line (`eval/mma2d_ab.py`) holds both layouts
    of kernels 4 and 11 to their plain versions through the wrappers at
    every width it times before it times anything; it exits 1 without a
    CUDA device."""
    from genomic_pca_tpu_torch.eval import mma2d_ab

    cpu = torch.device("cpu")
    for layout in ("packed", "dense"):
        for shape in mma2d_ab.CHECKS["right1d"][:2]:
            assert mma2d_ab.agrees("right1d", layout, *shape, cpu)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert mma2d_ab.main(["tag", "--lines", "right1d"]) == 1

"""The genotype kernels of the randomized-PCA core.

Eight serve the PLINK 2-bit packed layout - four the 1-D mode of the
container (every sample tile of a row band in one pass), four the
wide-sample 2-D mode, where the JAX package tiles both axes - and eight
the dense int8 layout: four of its 1-D mode, and its 2-D mode's two exact
products plus the int8 branches of the two 2-D q8 products, which dispatch
on the genotype dtype as the JAX functions do.  Each public function takes the
genotypes in ORIGINAL sample order - packed as a (D, N4) uint8 tensor
(byte j, bits 2p <-> sample 4j + p; no plane-major permutation), dense as
a (D, N) int8 tensor with -127 missing - per-SNP (D, 1) f32 columns, and
sample- or variant-indexed (., L) operands, and returns what the TPU
kernel of the same name in `genomic_pca_tpu/ops/pallas_kernels.py`
returns, un-permuted.  One more, `standardize_runs`, builds the
standardized block batches of EigenSNP stages 1-2 from either layout
(counted as `standardize_runs` packed, `standardize_runs_i8` dense).

Dispatch rule: a CPU tensor runs the plain PyTorch version beside each
kernel; a CUDA tensor launches the hand-written CUDA kernel (csrc/, built
by ops/build.py) or raises; any other device raises.  There is no
fallback from a failed launch.  `LAUNCHES[name]` counts launches of each
kernel and is bumped only where the kernel is launched.

Notation: A = diag(inv_std) (G - mean) with missing entries 0; G0 the raw
dosage with missing 0.  Exact kernels take `precision` "bf16" (operands
rounded to bf16 at the reference's points, f32 sums) or "f32".
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from genomic_pca_tpu_torch.ops.standardize import MISSING, standardize_rows
from genomic_pca_tpu_torch.utils.profiling import count

LAUNCHES: Dict[str, int] = {
    "fused_gram_q8_packed": 0,
    "fused_gram_apply_packed": 0,
    "fused_tsq_packed": 0,
    "fused_right_apply_packed": 0,
    "fused_right_apply_2d_packed": 0,
    "fused_left_apply_2d_packed": 0,
    "right_apply_2d_q8": 0,
    "left_apply_2d_q8": 0,
    "fused_gram_q8": 0,
    "fused_gram_apply": 0,
    "fused_tsq": 0,
    "fused_right_apply": 0,
    "fused_right_apply_2d": 0,
    "fused_left_apply_2d": 0,
    "right_apply_2d_q8_i8": 0,
    "left_apply_2d_q8_i8": 0,
    "standardize_runs": 0,
    "standardize_runs_i8": 0,
}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


# ---------------------------------------------------------------------------
# Shared decode (plain versions).


def packed_codes(packed: torch.Tensor) -> torch.Tensor:
    """(D, N4) uint8 -> (D, 4 * N4) int32 2-bit codes, original order."""
    c = packed.to(torch.int32)
    d, n4 = c.shape
    return torch.stack([(c >> (2 * p)) & 3 for p in range(4)], dim=-1).reshape(
        d, 4 * n4
    )


def unpack_dosages(packed: torch.Tensor) -> torch.Tensor:
    """(D, N4) uint8 -> (D, 4 * N4) int8 dosages with missing -> 0.

    Codes {0, 1, 2, 3} -> {2, 0, 1, 0}: g = (4 - c) >> 1 for c != 1."""
    c = packed_codes(packed)
    return torch.where(c != 1, (4 - c) >> 1, 0).to(torch.int8)


def dosages_g0(geno: torch.Tensor) -> torch.Tensor:
    """G0 of either layout: (D, N) int8 dosages with missing -> 0."""
    if geno.dtype == torch.uint8:
        return unpack_dosages(geno)
    return torch.clamp(geno, min=0)


def _round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _bf16(precision: str) -> bool:
    if precision not in ("bf16", "f32"):
        raise ValueError(f"precision must be 'bf16' or 'f32', got {precision!r}")
    return precision == "bf16"


def standardize_packed(packed, mean, inv_std, precision: str = "bf16"):
    """(D, 4 * N4) f32 standardized tile A, rounded as the TPU kernels
    round it in bf16 mode: bf16(g * bf16(inv_std) + bf16(-mean * inv_std))."""
    bf16 = _bf16(precision)
    c = packed_codes(packed)
    scale = inv_std
    shift = -mean * inv_std
    if bf16:
        scale, shift = _round_bf16(scale), _round_bf16(shift)
    x = ((4 - c) >> 1).to(torch.float32) * scale + shift
    if bf16:
        x = _round_bf16(x)
    return torch.where(c != 1, x, torch.zeros((), dtype=x.dtype, device=x.device))


def standardize_dense(geno, mean, inv_std, precision: str = "bf16"):
    """(D, N) f32 standardized tile A of int8 dosages (-127 missing),
    rounded as the TPU's dense bf16 tile rounds it
    (pallas_kernels.py:72-78): bf16(bf16(g * bf16(inv_std)) +
    bf16(-mean * inv_std)); f32 mode is `standardize_rows`."""
    if not _bf16(precision):
        return standardize_rows(geno, mean.reshape(-1), inv_std.reshape(-1))
    g = geno.to(torch.float32)
    x = _round_bf16(_round_bf16(g * _round_bf16(inv_std)) + _round_bf16(-mean * inv_std))
    return torch.where(geno != MISSING, x,
                       torch.zeros((), dtype=x.dtype, device=x.device))


def standardize(geno, mean, inv_std, precision: str = "bf16"):
    """The standardized tile A of either layout (uint8 packed, int8 dense)."""
    fn = standardize_packed if geno.dtype == torch.uint8 else standardize_dense
    return fn(geno, mean, inv_std, precision)


def standardize_runs_plain(geno, mean, inv_std, starts, lens, bucket: int):
    """(B, bucket, C) f32 standardized row runs of either layout: row i of
    block b is row starts[b] + i standardized in f32 for i < lens[b], else
    0; C = 4 * N4 packed, N dense.  `starts` and `lens` are (B,) int64
    tensors on the genotypes' device."""
    offs = torch.arange(bucket, device=geno.device)
    rows = torch.clamp(starts[:, None] + offs, max=geno.shape[0] - 1).reshape(-1)
    x = standardize(geno[rows], mean[rows], inv_std[rows], "f32").reshape(
        len(starts), bucket, -1)
    in_run = offs[None, :] < lens[:, None]
    return torch.where(in_run[:, :, None], x, torch.zeros((), device=geno.device))


def _operand(b: torch.Tensor, bf16: bool) -> torch.Tensor:
    b = b.to(torch.float32)
    return _round_bf16(b) if bf16 else b


# ---------------------------------------------------------------------------
# Plain versions, for either layout.


def fused_right_apply_packed_plain(geno, mean, inv_std, b, precision="bf16"):
    bf16 = _bf16(precision)
    return standardize(geno, mean, inv_std, precision) @ _operand(b, bf16)


def fused_gram_apply_packed_plain(geno, mean, inv_std, b, precision="bf16"):
    bf16 = _bf16(precision)
    x = standardize(geno, mean, inv_std, precision)
    w = _operand(x @ _operand(b, bf16), bf16)
    return x.T @ w


def fused_tsq_packed_plain(geno, mean, inv_std, b, precision="bf16"):
    bf16 = _bf16(precision)
    x = standardize(geno, mean, inv_std, precision)
    w = _operand(x @ _operand(b, bf16), bf16)
    return w.T @ w


def _exact_int_dtype(bound: int) -> torch.dtype:
    """f32 holds every integer sum below 2**24 exactly; past that, f64."""
    return torch.float32 if bound < 2**24 else torch.float64


def fused_left_apply_2d_packed_plain(geno, mean, inv_std, w, precision="bf16"):
    bf16 = _bf16(precision)
    return standardize(geno, mean, inv_std, precision).T @ _operand(w, bf16)


# Integer products are computed exactly in f32 / f64: int8 matmul wraps
# on the CPU and has no CUDA path.


def right_apply_2d_q8_plain(geno, bq):
    """Raw integer products G0 bq, computed exactly, rounded once to f32."""
    g0 = dosages_g0(geno)
    dt = _exact_int_dtype(2 * 127 * g0.shape[1])
    return (g0.to(dt) @ bq.to(dt)).to(torch.float32)


def _row_tiles(x: torch.Tensor, tile_d: int) -> torch.Tensor:
    """(D, C) -> (T, tile_d, C), the ragged last tile padded with zeros."""
    n_tiles = -(-x.shape[0] // tile_d)
    pad = n_tiles * tile_d - x.shape[0]
    return torch.nn.functional.pad(x, (0, 0, 0, pad)).reshape(
        n_tiles, tile_d, x.shape[1]
    )


def left_apply_2d_q8_plain(geno, z8, sz, tile_d, ranges=(0,)):
    """sum_t sz[t] (G0_t^T z8_t), folded in tile order (the reference
    kernel's order) as the card's kernel folds it: each tile's integer
    product exact, then out = out + P_t * sz[t] from zeros, one f32
    rounding for the multiply and one for the add.  `ranges` holds the first row tile of each range
    of rows (`q8_left2d_plan`'s): each range folds its tiles so from zeros,
    and the ranges' partials are added in range order, as
    sum_splits_kernel adds the kernel's slab."""
    g0 = dosages_g0(geno)
    d, n = g0.shape
    dt = _exact_int_dtype(2 * 127 * tile_d)
    bounds = [*ranges, -(-d // tile_d)]
    if bounds[0] != 0 or any(a >= b for a, b in zip(bounds, bounds[1:])):
        raise ValueError(f"ranges must be increasing first tiles from 0 below "
                         f"{bounds[-1]}, got {tuple(ranges)}")
    total = None
    for lo, hi in zip(bounds, bounds[1:]):
        part = torch.zeros((n, z8.shape[1]), dtype=torch.float32, device=geno.device)
        for t in range(lo, hi):
            rows = slice(t * tile_d, min(d, (t + 1) * tile_d))
            prod = (g0[rows].to(dt).T @ z8[rows].to(dt)).to(torch.float32)
            part = part + prod * sz[t]
        total = part if total is None else total + part
    return total


def quantize_rows(z: torch.Tensor, tile_d: int):
    """Per-row-tile int8 quantization of z (D, L): (z8 (D, L) int8, sz (T,)
    f32) with sz = max|z| / 127 over each (tile_d, L) tile, as the
    reference's q8 passes quantize it."""
    z_t = _row_tiles(z, tile_d)
    sz = z_t.abs().amax(dim=(1, 2)) * (1.0 / 127.0) + 1e-30
    z8 = torch.clamp(torch.round(z_t * (1.0 / sz)[:, None, None]), -127.0, 127.0)
    return z8.reshape(-1, z.shape[1])[: z.shape[0]].to(torch.int8), sz


def q8_requant_plain(w, inv_std, u, sb, csum, tile_d):
    """The step between the two integer products of a q8 pass: from W = G0
    bq (D, L) f32, y = s (W sb) - u csum and z = s y (each operation
    rounded on its own), z quantized per row tile of `tile_d`
    (`quantize_rows`).  Returns (z8 (D, L) int8, sz (T,) f32, ru = sum u y
    (1, L)); the card's requantization kernel gives the same z8 and sz bits
    and ru in its own sum order."""
    y = inv_std * (w * sb) - u * csum
    z8, sz = quantize_rows(inv_std * y, tile_d)
    return z8, sz, (u * y).sum(dim=0, keepdim=True)


def fused_gram_q8_packed_plain(geno, inv_std, u, bq, sb, csum, tile_d=1024,
                               ranges=(0,)):
    """Plain q8 pass: the kernel's quantization model, integer products
    exact: W = G0 bq, `q8_requant_plain`, then sum_t sz[t] G0_t^T z8_t
    folded as `left_apply_2d_q8_plain` folds it at `ranges` (default: tile
    order, the JAX kernel's).  Returns (out, ru)."""
    w = right_apply_2d_q8_plain(geno, bq)
    z8, sz, ru = q8_requant_plain(w, inv_std, u, sb, csum, tile_d)
    return left_apply_2d_q8_plain(geno, z8, sz, tile_d, ranges), ru


# The dense kernels compute the same functions of the same G0 and A.
fused_gram_q8_plain = fused_gram_q8_packed_plain
fused_gram_apply_plain = fused_gram_apply_packed_plain
fused_tsq_plain = fused_tsq_packed_plain
fused_right_apply_plain = fused_right_apply_packed_plain


# ---------------------------------------------------------------------------
# Launch helpers.

# C entry points of each pass, by genotype layout.
_ENTRY = {
    torch.uint8: {"right": "gp_right_packed", "left": "gp_left_packed",
                  "gram": "gp_gram_packed", "tsq": "gp_tsq_packed",
                  "q8_pass": "gp_q8_pass_packed",
                  "left2d": "gp_left2d_packed", "right2d": "gp_right2d_packed",
                  "right_narrow": "gp_right_narrow_packed",
                  "q8_right2d": "gp_q8_right2d", "q8_left2d": "gp_q8_left2d"},
    torch.int8: {"right": "gp_right_dense", "left": "gp_left_dense",
                 "gram": "gp_gram_dense", "tsq": "gp_tsq_dense",
                 "q8_pass": "gp_q8_pass_dense",
                 "left2d": "gp_left2d_dense", "right2d": "gp_right2d_dense",
                 "right_narrow": "gp_right_narrow_dense",
                 "q8_right2d": "gp_q8_right2d_dense", "q8_left2d": "gp_q8_left2d_dense"},
}


def _launch(device: torch.device, entry: str, *args) -> None:
    """Call C entry `entry` of the kernel library on `device`'s current
    stream; tensors pass as pointers.  Raises on a refused launch."""
    from genomic_pca_tpu_torch.ops.build import lib

    args = [a.data_ptr() if torch.is_tensor(a) else a for a in args]
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        rc = getattr(lib(), entry)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {entry} failed: cudaError {rc}")


def _require(t: torch.Tensor, name: str, dtype, shape, device) -> torch.Tensor:
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name}: expected device {device}, got {t.device}")
    return t.contiguous()


def _route(geno: torch.Tensor) -> str:
    if geno.device.type == "cpu":
        return "plain"
    if geno.device.type == "cuda":
        return "cuda"
    raise ValueError(
        f"no kernel for device {geno.device}: genotype kernels run on "
        "cuda (hand-written kernel) or cpu (plain version)"
    )


def _split(device: torch.device, tiles_2d: int, units: int, unit: int = 1):
    """Split-K layout over `units` work units of `unit` rows each: about 8
    blocks per SM.  Returns (layers, rows per layer)."""
    layers = max(1, min(units, -(-8 * _sms(device) // max(tiles_2d, 1))))
    per = -(-units // layers)
    return -(-units // per), per * unit


def _check_geno(geno: torch.Tensor, dtype) -> torch.Tensor:
    """The (D, C) genotype tensor of the layout `dtype`, contiguous.  The
    dense loader reads one 32-bit word (four samples) per group, so a
    dense row must hold a multiple of 4 samples and the base be 4-byte
    aligned (`from_arrays` pads rows to a multiple of 128)."""
    name = "packed" if dtype == torch.uint8 else "geno"
    if geno.dim() != 2:
        raise ValueError(f"{name} must be 2-D, got shape {tuple(geno.shape)}")
    geno = _require(geno, name, dtype, geno.shape, geno.device)
    if dtype == torch.int8 and (geno.shape[1] % 4 or geno.data_ptr() % 4):
        raise ValueError(
            "dense kernels read four samples per aligned 32-bit word: the "
            f"sample count must be a multiple of 4, got {geno.shape[1]}"
        )
    return geno


def _layout(geno: torch.Tensor):
    """The layout dtype of a 2-D kernel's genotypes: uint8 (packed) or
    int8 (dense), the dispatch of the JAX 2-D q8 functions."""
    if geno.dtype not in (torch.uint8, torch.int8):
        raise TypeError(f"genotypes must be uint8 (packed) or int8 (dense), "
                        f"got {geno.dtype}")
    return geno.dtype


def _samples(geno: torch.Tensor) -> int:
    return 4 * geno.shape[1] if geno.dtype == torch.uint8 else geno.shape[1]


def _check_common(geno, mean, inv_std, b, precision, dtype=torch.uint8):
    _bf16(precision)
    geno = _check_geno(geno, dtype)
    d, n = geno.shape[0], _samples(geno)
    dev = geno.device
    mean = _require(mean, "mean", torch.float32, (d, 1), dev)
    inv_std = _require(inv_std, "inv_std", torch.float32, (d, 1), dev)
    if b.dim() != 2 or b.shape[0] != n:
        raise ValueError(f"b must be ({n}, L), got {tuple(b.shape)}")
    b = _require(b, "b", torch.float32, b.shape, dev)
    return geno, mean, inv_std, b


def _launch_right(geno, mean, inv_std, b):
    """A B (D, L) f32 through the f32 FMA loop (gp_right_packed /
    gp_right_dense) in f32 mode: the exact passes' f32 mode ("HIGHEST" in
    the reference)."""
    d = geno.shape[0]
    ell = b.shape[1]
    out = torch.empty((d, ell), dtype=torch.float32, device=geno.device)
    _launch(geno.device, _ENTRY[geno.dtype]["right"], geno, mean, inv_std, b,
            out, d, _samples(geno) // 4, ell, 0, 0)
    return out


# The widest B the narrow kernel takes in one column block, and so the
# widest it serves: past it (no n32 form) a bf16 call takes the 2-D right
# product's f32 store (PERF.md, the crossover of the two routes).
NARROW_MAX_L = 16


def right1d_route(ell: int, precision: str) -> str:
    """The kernel a CUDA call of the 1-D right products (kernels 4 and 11)
    launches for B of `ell` columns: "narrow" (right_narrow_mma_kernel,
    bf16, ell <= NARROW_MAX_L), "wide" (right2d_mma_kernel's f32 store,
    bf16) or "fma" (the f32 FMA loop, f32 mode)."""
    if not _bf16(precision):
        return "fma"
    return "narrow" if ell <= NARROW_MAX_L else "wide"


def _launch_right1d(geno, mean, inv_std, b, precision):
    route = right1d_route(b.shape[1], precision)
    if route == "fma":
        return _launch_right(geno, mean, inv_std, b)
    if route == "wide":
        return _launch_right2d(geno, mean, inv_std, b)
    return _launch_right_narrow(geno, mean, inv_std, b)


def _launch_gram(geno, mean, inv_std, b, bf16: bool):
    """A^T (A B), W = A B rounded to bf16 in bf16 mode.  bf16: one call of
    the gram entry (gp_gram_packed / gp_gram_dense: the tensor-core right
    product storing W as bf16, then the tensor-core left product), with
    one workspace of the size `gram_plan` reports.  f32: the f32 FMA right
    loop, then A^T W split-K with f32 atomics."""
    d, n, ell, dev = geno.shape[0], _samples(geno), b.shape[1], geno.device
    if not bf16:
        w = _launch_right(geno, mean, inv_std, b)
        out = torch.zeros((n, ell), dtype=torch.float32, device=dev)
        splits, rows = _split(dev, -(-n // 64) * -(-ell // 64), -(-d // 16), 16)
        _launch(dev, _ENTRY[geno.dtype]["left"], geno, mean, inv_std, w, out, d,
                n // 4, ell, 0, splits, rows)
        return out
    if not (d and n and ell):
        return torch.zeros((n, ell), dtype=torch.float32, device=dev)
    geno, mean, inv_std, b = _mma_operands(geno, mean, inv_std, b)
    groups, sms = _samples(geno) // 4, _sms(dev)
    work = torch.empty(gram_plan(d, groups, n, ell, sms)[2], dtype=torch.uint8,
                       device=dev)
    out = torch.empty((4 * groups, ell), dtype=torch.float32, device=dev)
    _launch(dev, _ENTRY[geno.dtype]["gram"], geno, mean, inv_std, b, out, work, d,
            groups, n, ell, b.shape[1], sms)
    return out[:n]


def _launch_tsq(geno, mean, inv_std, b, bf16: bool):
    """W^T W, W = A B rounded to bf16 in bf16 mode.  bf16: one call of the
    tsq entry (gp_tsq_packed / gp_tsq_dense: the gram pass's tensor-core
    right product storing W as bf16, then W^T W on the tensor cores), with
    one workspace of the size `tsq_plan` reports.  f32 ("HIGHEST" in the
    reference): the f32 FMA right loop, then W^T W split-K with f32
    atomics (gp_wtw) - a dispatch on the precision, not a fallback."""
    d, n, ell, dev = geno.shape[0], _samples(geno), b.shape[1], geno.device
    if not bf16:
        w = _launch_right(geno, mean, inv_std, b)
        out = torch.zeros((ell, ell), dtype=torch.float32, device=dev)
        splits, rows = _split(dev, (-(-ell // 64)) ** 2, -(-d // 16), 16)
        _launch(dev, "gp_wtw", w, out, d, ell, splits, rows)
        return out
    if not (d and n and ell):
        return torch.zeros((ell, ell), dtype=torch.float32, device=dev)
    geno, mean, inv_std, b = _mma_operands(geno, mean, inv_std, b)
    groups, sms = _samples(geno) // 4, _sms(dev)
    work = torch.empty(tsq_plan(d, groups, n, ell, sms)[2], dtype=torch.uint8,
                       device=dev)
    out = torch.empty((ell, ell), dtype=torch.float32, device=dev)
    _launch(dev, _ENTRY[geno.dtype]["tsq"], geno, mean, inv_std, b, out, work, d,
            groups, n, ell, b.shape[1], sms)
    return out


def _check_q8(geno, inv_std, u, bq, sb, csum, tile_d, dtype=torch.uint8):
    if tile_d <= 0 or tile_d % 64:
        raise ValueError(f"tile_d must be a positive multiple of 64, got {tile_d}")
    geno = _check_geno(geno, _layout(geno) if dtype is None else dtype)
    d, n = geno.shape[0], _samples(geno)
    dev = geno.device
    if bq.dim() != 2 or bq.shape[0] != n:
        raise ValueError(f"bq must be ({n}, L), got {tuple(bq.shape)}")
    ell = bq.shape[1]
    return (
        geno,
        _require(inv_std, "inv_std", torch.float32, (d, 1), dev),
        _require(u, "u", torch.float32, (d, 1), dev),
        _require(bq, "bq", torch.int8, (n, ell), dev),
        _require(sb, "sb", torch.float32, (1, 1), dev),
        _require(csum, "csum", torch.float32, (1, ell), dev),
    )


def _launch_q8_pass(geno, inv_std, u, bq, sb, csum, tile_d, names):
    """One q8 pass through the one C call of its layout (gp_q8_pass_packed /
    gp_q8_pass_dense, csrc/q8_pass.cuh): (out (N, L), ru (1, L)).  Adds 1
    to the launch count of each of `names`.  The rows are copied once where
    they are not whole 16-byte units (`aligned_rows`); bq^T, W, z8^T and
    the slabs live in one workspace of the size `q8_pass_plan` reports."""
    d, n, ell, dev = geno.shape[0], _samples(geno), bq.shape[1], geno.device
    for name in names:
        LAUNCHES[name] += 1
    if not (d and n and ell):
        return (torch.zeros((n, ell), dtype=torch.float32, device=dev),
                torch.zeros((1, ell), dtype=torch.float32, device=dev))
    geno, sms = aligned_rows(geno), _sms(dev)
    width = _samples(geno)
    work = torch.empty(q8_pass_plan(d, width, ell, tile_d, sms)[2], dtype=torch.uint8,
                       device=dev)
    out = torch.empty((width, ell), dtype=torch.float32, device=dev)
    ru = torch.empty((1, ell), dtype=torch.float32, device=dev)
    _launch(dev, _ENTRY[geno.dtype]["q8_pass"], geno, inv_std, u, bq, sb, csum, out, ru,
            work, d, width // 4, n, ell, tile_d, sms)
    return out[:n], ru


# ---------------------------------------------------------------------------
# The four kernels of the packed 1-D mode.
#
# fused_right_apply_packed replaces genomic_pca_tpu/ops/pallas_kernels.py
# fused_right_apply_packed (:529, pallas_call :545; body
# _right_packed_kernel :464): A B with out f32, not rounded.  It computes
# the loadings A V_k of every resident 1-D core (L = k = 10) and, in the
# host-streamed container, each strip's A B (L = 128 in its tsq pass).  A
# dispatch on the precision and B's width (`right1d_route`): in bf16 mode
# L <= 16 launches right_narrow_mma_kernel (csrc/right1d_kernels.cu; see
# `_launch_right_narrow`), wider B right2d_mma_kernel's f32 store (kernel
# 5's: the same function, so its bits); f32 mode the f32 FMA loop
# right_kernel.  At 262,144 x 2,048, L = 10 it is bound on an H100 by its
# 134 MB of genotype bytes (0.04 ms): the narrow kernel decodes each byte
# in the consumers' registers into the A fragments of wgmma m64n16k16 (A
# from registers), with no decoded tile and no empty columns.


def fused_right_apply_packed(packed, mean, inv_std, b, precision="bf16"):
    """A B: (D, L) f32."""
    packed, mean, inv_std, b = _check_common(packed, mean, inv_std, b, precision)
    if _route(packed) == "plain":
        return fused_right_apply_packed_plain(packed, mean, inv_std, b, precision)
    LAUNCHES["fused_right_apply_packed"] += 1
    return _launch_right1d(packed, mean, inv_std, b, precision)


# fused_gram_apply_packed replaces pallas_kernels.py fused_gram_apply_packed
# (:492, pallas_call :508; body _gram_packed_kernel :447).  The TPU kernel
# keeps the (N, L) accumulator in VMEM across a sequential grid; Hopper
# blocks run in parallel, and one fused block would need that whole
# accumulator or W for every row, so in bf16 mode the pass is two
# tensor-core products in one C call (gp_gram_packed, csrc/gram.cuh): W =
# A B by right2d_mma_kernel, stored as bf16 (each f32 total rounded once,
# as the reference rounds w.astype(bf16): 2*D*L bytes written and read,
# 64 MiB at 262,144 x 128), then A^T W by left2d_mma_kernel with the rows
# split into fixed-order ranges of whole folds where its sample tiles are
# fewer than the SMs (2,048 samples: 16 tiles x 8 ranges).  No atomics:
# the same bits every call.  Bound on an H100 by the bf16 tensor-core
# rate: 4*D*N*L operations, 0.278 ms at 262,144 x 2,048 x 128.  f32 mode
# keeps the f32 FMA loops (right_kernel, then left_kernel split-K with f32
# atomics).


def fused_gram_apply_packed(packed, mean, inv_std, b, precision="bf16"):
    """A^T (A B): (4 * N4, L) f32, original sample order."""
    packed, mean, inv_std, b = _check_common(packed, mean, inv_std, b, precision)
    if _route(packed) == "plain":
        return fused_gram_apply_packed_plain(packed, mean, inv_std, b, precision)
    LAUNCHES["fused_gram_apply_packed"] += 1
    return _launch_gram(packed, mean, inv_std, b, _bf16(precision))


# fused_tsq_packed replaces pallas_kernels.py fused_tsq_packed (:564,
# pallas_call :580; body _tsq_packed_kernel :472), the Rayleigh-Ritz Gram
# of the resident 1-D core.  In bf16 mode one C call (gp_tsq_packed,
# csrc/gram.cuh): W = A B by right2d_mma_kernel with the gram pass's plan,
# stored as bf16 (each f32 total rounded once, as the reference rounds
# wc = w.astype(bf16)), then W^T W by wtw_mma_kernel (csrc/wtw_kernels.cu):
# one block per 128 x 128 output tile and range of whole 1,024-row folds
# (`tsq_plan`: 128 ranges at 262,144 x 128 on 132 SMs), the ranges' slab
# added in a fixed order.  No atomics: the same bits every call.  Bound on
# an H100 by the bf16 tensor-core rate: 2*D*N*L + 2*D*L*L operations,
# 0.148 ms at 262,144 x 2,048 x 128 (W^T W alone by W's 64 MiB: 20 us).
# f32 mode keeps the f32 FMA loops (right_kernel, then wtw_kernel split-K
# with f32 atomics).


def fused_tsq_packed(packed, mean, inv_std, b, precision="bf16"):
    """(A B)^T (A B): (L, L) f32."""
    packed, mean, inv_std, b = _check_common(packed, mean, inv_std, b, precision)
    if _route(packed) == "plain":
        return fused_tsq_packed_plain(packed, mean, inv_std, b, precision)
    LAUNCHES["fused_tsq_packed"] += 1
    return _launch_tsq(packed, mean, inv_std, b, _bf16(precision))


# fused_gram_q8_packed replaces pallas_kernels.py fused_gram_q8_packed
# (:977, pallas_call :995; body _gram_q8_packed_kernel :950, decode
# _unpack_packed_tile_s8 :902).  The per-tile scale max|z| over a whole
# (tile_d, L) tile needs a reduction before the second product, so the
# pass is one C call of three steps (gp_q8_pass_packed, csrc/q8_pass.cuh):
# W = G0 bq by kernel 7's s8 wgmma (q8_right2d_mma_kernel), exact in int32
# and stored as f32; a requantization kernel (y, z, the tile maxima, sz,
# z8 written straight into z8^T, ru in a fixed order); then sum_t sz[t]
# G0_t^T z8_t by kernel 8's s8 wgmma (q8_left2d_mma_kernel) with its row
# split (8 ranges at 2,048 samples).  No atomics: the same bits every call,
# and `out` equals the plain version at the plan's row ranges
# (`q8_pass_plan`) bit for bit.  Bound on an H100 at 262,144 x 2,048 x 128
# by the int8 tensor-core rate (4*D*N*L operations, 0.139 ms); the design
# reads G twice and sends W (128 MiB) there and back.  `tile_d`, the
# quantization tile, is a multiple of 64, independent of the block shapes.


def fused_gram_q8_packed(packed, inv_std, u, bq, sb, csum, tile_d=1024):
    """Quantized power pass: (out (4 * N4, L), ru (1, L)); the caller
    forms T = out - ru.  `bq` (4 * N4, L) int8, `sb` (1, 1), `csum` (1, L)
    as returned by ops.rsvd.quantize_basis."""
    packed, inv_std, u, bq, sb, csum = _check_q8(packed, inv_std, u, bq, sb,
                                                 csum, tile_d)
    if _route(packed) == "plain":
        return fused_gram_q8_packed_plain(packed, inv_std, u, bq, sb, csum, tile_d)
    return _launch_q8_pass(packed, inv_std, u, bq, sb, csum, tile_d,
                           ("fused_gram_q8_packed",))


# ---------------------------------------------------------------------------
# The four kernels of the dense int8 1-D mode (csrc/dense_kernels.cu,
# q8_kernels.cu): the packed kernels' designs over int8 rows.  Each pass
# reads D*N bytes, four times the packed bytes; the q8 pass, and the gram,
# tsq and right products in bf16 mode, run on the tensor cores, the f32
# mode's FMA loops read one aligned 32-bit word of four samples per thread
# where the packed ones read a byte.
#
# fused_right_apply replaces pallas_kernels.py fused_right_apply (:181,
# pallas_call :197; body _right_kernel :112): the packed product's routes
# over int8 rows (right_narrow_mma_kernel<DenseRows>, the bf16x2 decode of
# the 2-D kernels in the consumers' registers), bound by its D*N bytes
# (0.16 ms at 262,144 x 2,048).  It also computes the loadings of the
# dense EigenSNP finalize (65,536 x 10,000, L = 10).


def fused_right_apply(geno, mean, inv_std, b, precision="bf16"):
    """A B over (D, N) int8 dosages: (D, L) f32."""
    geno, mean, inv_std, b = _check_common(geno, mean, inv_std, b, precision,
                                           torch.int8)
    if _route(geno) == "plain":
        return fused_right_apply_plain(geno, mean, inv_std, b, precision)
    LAUNCHES["fused_right_apply"] += 1
    return _launch_right1d(geno, mean, inv_std, b, precision)


# fused_gram_apply replaces pallas_kernels.py fused_gram_apply (:144,
# pallas_call :160; body _gram_kernel :95).  The TPU kernel carries the
# (N, L) accumulator through a sequential grid; here, in bf16 mode, the
# packed pass's design over int8 rows (gp_gram_dense): W = A B by
# right2d_mma_kernel<DenseRows> stored as bf16, then A^T W by
# left2d_mma_kernel<DenseRows> with its row split.  Bound on an H100 by
# the bf16 tensor-core rate (4*D*N*L operations, 0.278 ms at 262,144 x
# 2,048 x 128; its 512 MiB of int8 take 0.16 ms).  f32 mode keeps the f32
# FMA loops.


def fused_gram_apply(geno, mean, inv_std, b, precision="bf16"):
    """A^T (A B) over (D, N) int8 dosages: (N, L) f32."""
    geno, mean, inv_std, b = _check_common(geno, mean, inv_std, b, precision,
                                           torch.int8)
    if _route(geno) == "plain":
        return fused_gram_apply_plain(geno, mean, inv_std, b, precision)
    LAUNCHES["fused_gram_apply"] += 1
    return _launch_gram(geno, mean, inv_std, b, _bf16(precision))


# fused_tsq replaces pallas_kernels.py fused_tsq (:215, pallas_call :231;
# body _tsq_kernel :120): in bf16 mode the packed pass's design over int8
# rows (gp_tsq_dense): W = A B by right2d_mma_kernel<DenseRows> stored as
# bf16, then W^T W by wtw_mma_kernel.  Bound on an H100 by its 512 MiB of
# int8 at 262,144 x 2,048 (0.16 ms; the operations take 0.148 ms).  f32
# mode keeps the f32 FMA loops.


def fused_tsq(geno, mean, inv_std, b, precision="bf16"):
    """(A B)^T (A B) over (D, N) int8 dosages: (L, L) f32."""
    geno, mean, inv_std, b = _check_common(geno, mean, inv_std, b, precision,
                                           torch.int8)
    if _route(geno) == "plain":
        return fused_tsq_plain(geno, mean, inv_std, b, precision)
    LAUNCHES["fused_tsq"] += 1
    return _launch_tsq(geno, mean, inv_std, b, _bf16(precision))


# fused_gram_q8 replaces pallas_kernels.py fused_gram_q8 (:847,
# pallas_call :863; body _gram_q8_kernel :807): the packed q8 pass's one C
# call over int8 rows (gp_q8_pass_dense), kernels 7i and 8i with G0 =
# max(g, 0), so the -127 sentinel is raw 0.  Bound on an H100 by its D*N
# bytes (0.16 ms at 262,144 x 2,048); it reads them twice.
# The quantization tile is the container's tile_d (1,024), where the JAX
# container takes auto_tile_d's VMEM tile (1,024 at n_pad 2,048, 256 at
# 4,096): that changes only how the steering passes quantize z.


def fused_gram_q8(geno, inv_std, u, bq, sb, csum, tile_d=1024):
    """Quantized power pass over (D, N) int8 dosages: (out (N, L), ru
    (1, L)); same contract as `fused_gram_q8_packed`."""
    geno, inv_std, u, bq, sb, csum = _check_q8(geno, inv_std, u, bq, sb, csum,
                                               tile_d, torch.int8)
    if _route(geno) == "plain":
        return fused_gram_q8_plain(geno, inv_std, u, bq, sb, csum, tile_d)
    return _launch_q8_pass(geno, inv_std, u, bq, sb, csum, tile_d, ("fused_gram_q8",))


# ---------------------------------------------------------------------------
# The four kernels of the wide-sample (2-D) mode.
#
# fused_right_apply_2d_packed replaces pallas_kernels.py
# fused_right_apply_2d_packed (:675, pallas_call :692; body
# _right2d_packed_kernel :642): A B with W (D, L) in f32, not rounded, B
# rounded to bf16 in bf16 mode.  Bound on an H100 by the bf16 tensor-core
# rate: 2*D*N*L operations (0.278 ms at 65,536 x 16,384 x 128) against
# D*N4 bytes.  Design (right2d_mma_kernel, csrc/right2d_kernels.cu): the
# left product's pipeline turned over - one block per 128 rows x 128
# columns loops over the samples in chunks of 128; a loader warp's TMA
# loads bring the raw half tiles and the bf16 B tiles; a producer
# warpgroup decodes with per-row codes built once a block; two consumer
# warpgroups run wgmma with the decoded tile K-major.  Where the row
# blocks are fewer than the SMs (a thin strip) the samples split into
# ranges whose partial slabs are added in a fixed order
# (`right2d_plan`): no atomics, the same bits every launch.  f32 mode
# launches the f32 FMA loop of the 1-D mode's right product
# (gp_right_packed, round_out = 0).


def fused_right_apply_2d_packed(packed, mean, inv_std, b, precision="bf16"):
    """A B: (D, L) f32, W not rounded."""
    return _right2d(packed, mean, inv_std, b, precision, torch.uint8,
                    "fused_right_apply_2d_packed")


# The 1-D mode's right product is the same function.
fused_right_apply_2d_packed_plain = fused_right_apply_packed_plain


# fused_left_apply_2d_packed replaces pallas_kernels.py
# fused_left_apply_2d_packed (:723, pallas_call :741; body
# _left2d_packed_kernel :657): A^T W with W (D, L) f32, rounded to bf16 in
# bf16 mode.  Bound on an H100 by the bf16 tensor-core rate: 2*D*N*L
# operations (0.278 ms at 65,536 x 16,384 x 128) against D*N4 bytes.
# Design (left2d_mma_kernel, csrc/wide_kernels.cu): one block per 128
# samples x 128 columns loops over every row in chunks of 64 - no atomics,
# a deterministic sum order; where those blocks are fewer than the SMs
# (narrow matrices; never at the 2-D switch widths) the rows split into
# ranges of whole folds whose partial slabs are added in a fixed order
# (`left2d_plan`).  A loader warp's TMA loads bring
# the packed bytes, the moments and the bf16 W tiles (128-byte swizzled)
# into shared-memory rings handed over by mbarriers; a producer warpgroup
# decodes each byte into the bf16 A tile (a per-row table of nibble
# pairs); two consumer warpgroups run wgmma on the swizzled tiles.  f32
# mode keeps the f32 FMA loop (left2d_kernel).
#
# Both tensor-core products read their operands with TMA, which wants
# 16-byte aligned bases and row strides (`_mma_operands`), and round W or B
# to bf16 once in the wrapper (`mma_operand`), as `_round_bf16` rounds it
# in the plain versions.

@functools.lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _current_sms(sms) -> int:
    return sms if sms is not None else _sms(
        torch.device("cuda", torch.cuda.current_device()))


@functools.lru_cache(maxsize=512)
def _library_plan(entry: str, size: int, ctype, *args) -> tuple:
    """The `size` numbers C entry `entry` reports for `args`: a plan
    depends on its integers alone, so a pass asks the library once."""
    from genomic_pca_tpu_torch.ops.build import lib

    plan = (ctype * size)()
    getattr(lib(), entry)(*args, ctypes.addressof(plan))
    return tuple(plan)


def left2d_plan(d: int, n_samples: int, ell: int, sms: int = None) -> tuple:
    """(tile, grid, ranges) of the tensor-core left product over `d` rows,
    `n_samples` samples and `ell` columns of W on `sms` SMs (default: the
    current CUDA device's), as launch_left2d launches it: tile (samples,
    columns), grid (sample blocks, column blocks), and the ranges the rows
    split into where the blocks are fewer than the SMs (each a partial
    slab, added in a fixed order).  Read from the built library
    (`gp_left2d_plan`), so that a log shows what the launch uses.  The
    padded copy of `aligned_rows` (to 64 samples packed, 16 dense) never
    changes the plan: both divide the tile."""
    p = _library_plan("gp_left2d_plan", 5, ctypes.c_int, d, -(-n_samples // 4),
                      ell, _current_sms(sms))
    return (p[0], p[1]), (p[2], p[3]), p[4]


def gram_plan(d: int, groups: int, n: int, ell: int, sms: int = None) -> tuple:
    """The plans of the bf16 gram pass (gp_gram_packed / gp_gram_dense)
    over `d` rows of `groups` groups of four samples, `n` samples of B and
    `ell` columns on `sms` SMs: ((tile, grid, sample splits) of its right
    product, (tile, grid, row ranges) of its left product, workspace
    bytes), read from the built library (`gp_gram_plan`).  The right
    product's grid counts its output tiles; with one sample range a
    persistent grid of at most one block an SM walks them."""
    p = _library_plan("gp_gram_plan", 11, ctypes.c_longlong, d, groups, n, ell,
                      _current_sms(sms))
    return ((p[0], p[1]), (p[2], p[3]), p[4]), ((p[5], p[6]), (p[7], p[8]), p[9]), p[10]


def tsq_plan(d: int, groups: int, n: int, ell: int, sms: int = None) -> tuple:
    """The plans of the bf16 tsq pass (gp_tsq_packed / gp_tsq_dense) over
    `d` rows of `groups` groups of four samples, `n` samples of B and `ell`
    columns on `sms` SMs: ((tile, grid, sample splits) of its right
    product - the gram pass's, see `gram_plan` -, (tile, grid, row ranges)
    of W^T W, workspace bytes), read from the built library
    (`gp_tsq_plan`).  W^T W's tile is 128 x 128 of the (L, L) output; its
    rows split into ranges of whole 1,024-row folds, each a partial (L, L)
    slab added in a fixed order."""
    p = _library_plan("gp_tsq_plan", 11, ctypes.c_longlong, d, groups, n, ell,
                      _current_sms(sms))
    return ((p[0], p[1]), (p[2], p[3]), p[4]), ((p[5], p[6]), (p[7], p[8]), p[9]), p[10]


def right2d_plan(d: int, n_samples: int, ell: int, sms: int = None) -> tuple:
    """(tile, grid, splits) of the tensor-core right product over `d` rows,
    `n_samples` samples and `ell` columns of B on `sms` SMs (default: the
    current CUDA device's), as launch_right2d launches it: tile (rows,
    columns), grid (row blocks, column blocks), and the ranges the samples
    split into where the blocks are fewer than the SMs.  Read from the
    built library (`gp_right2d_plan`)."""
    p = _library_plan("gp_right2d_plan", 5, ctypes.c_int, d, n_samples, ell,
                      _current_sms(sms))
    return (p[0], p[1]), (p[2], p[3]), p[4]


def right_narrow_plan(d: int, n_samples: int, ell: int, dtype=torch.uint8,
                      sms: int = None) -> tuple:
    """(tile, blocks, splits, chunk, workspace bytes) of the narrow right
    product over `d` rows of `n_samples` samples (the genotype rows'
    width) of the layout `dtype` (uint8 packed, int8 dense) and `ell`
    columns of B on `sms` SMs (default: the current CUDA device's), as
    launch_right_narrow launches it: tile (rows, columns), the persistent
    grid's blocks, the ranges the samples split into where the tiles are
    fewer than the SMs, the samples of a chunk (the unit of
    `right_narrow_operand`'s order), and the bytes of the workspace the C
    call takes (B in that order, then the ranges' slab).  Read from the
    built library (`gp_right_narrow_plan`)."""
    group = 1 if dtype == torch.uint8 else 4
    p = _library_plan("gp_right_narrow_plan", 6, ctypes.c_longlong, d,
                      n_samples * group // 4, group, ell, _current_sms(sms))
    return (p[0], p[1]), p[2], p[3], p[4], p[5]


def right_narrow_operand(b: torch.Tensor, chunk: int, samples: int = None) -> torch.Tensor:
    """B (N, L) as the narrow right product reads it (built on the card by
    narrow_operand_kernel in the same C call; this states the order and
    serves the tests): bf16, rounded to
    nearest even once, zero-padded to a multiple of 16 columns and to
    whole chunks of `chunk` samples past max(N, `samples`) (TMA fills
    bytes past a row with zeros, which decode to dosage 2 packed: they
    must meet zero rows of B), in column blocks of 16, each a run of K
    steps of 16 samples stored as the K-major 16 x 16 operand of wgmma (two
    8-column groups 256 bytes apart, two 8-sample halves 128 bytes apart,
    a column's 8 samples in 16 bytes).  Step m of chunk s holds in K slots
    {2q, 2q + 1, 2q + 8, 2q + 9} the samples s chunk + (chunk / 4) q + 4 m +
    {0, 1, 2, 3}: those of the byte (packed) or word (dense) that lane q
    of a row decodes.  Shape (column blocks, K steps, 256)."""
    n, ell = b.shape
    n_pad = -(-max(n, samples or 0) // chunk) * chunk
    blocks = max(1, -(-ell // 16))
    bp = torch.nn.functional.pad(b, (0, 16 * blocks - ell, 0, n_pad - n))
    # (chunk s, lane q, step m, K half kh, sample pair pl, column block c,
    # column group nh, column n8): sample p = 2 kh + pl, column 16 c + 8 nh + n8.
    x = bp.view(n_pad // chunk, 4, chunk // 16, 2, 2, blocks, 2, 8)
    out = torch.empty((blocks, n_pad // 16, 256), dtype=torch.bfloat16, device=b.device)
    out.view(blocks, n_pad // chunk, chunk // 16, 2, 2, 8, 4, 2).copy_(
        x.permute(5, 0, 2, 6, 3, 7, 1, 4))
    return out


def mma_operand(x: torch.Tensor) -> torch.Tensor:
    """W of the left product or B of the right, (K, L) f32, as the
    tensor-core products read it: bf16, rounded to nearest even once (the
    rounding of `_round_bf16`), columns padded with zeros to a multiple of
    8 so that a row is whole 16-byte units."""
    k, ell = x.shape
    lw = -(-ell // 8) * 8
    if lw == ell:
        return x.to(torch.bfloat16)
    out = torch.zeros((k, lw), dtype=torch.bfloat16, device=x.device)
    out[:, :ell] = x
    return out


def aligned_rows(geno: torch.Tensor) -> torch.Tensor:
    """The genotype rows as the tensor-core kernels load them (TMA):
    `geno` itself when its rows are whole 16-byte units from a 16-byte
    aligned base (every container's width is: 128 bytes packed, 128
    samples dense), else a copy padded with missing codes (0x55 packed,
    -127 dense), which standardize to 0."""
    d, cols = geno.shape
    if cols % 16 == 0 and geno.data_ptr() % 16 == 0:
        return geno
    pad = 0x55 if geno.dtype == torch.uint8 else MISSING
    out = torch.full((d, -(-cols // 16) * 16), pad, dtype=geno.dtype,
                     device=geno.device)
    out[:, :cols] = geno
    return out


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """`t`, or a copy where its base is not 16-byte aligned (TMA)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _mma_operands(geno, mean, inv_std, x):
    """The operands of a tensor-core product as its TMA loads read them:
    `aligned_rows` of the genotypes, the moments (copied where
    misaligned), and W or B through `mma_operand`."""
    return aligned_rows(geno), _aligned(mean), _aligned(inv_std), mma_operand(x)


def _launch_right2d(geno, mean, inv_std, b):
    """A B (D, L) f32 through right2d_mma_kernel's f32 store, with a slab
    of partials where `right2d_plan` splits the samples."""
    d, (n, ell), dev = geno.shape[0], b.shape, geno.device
    out = torch.empty((d, ell), dtype=torch.float32, device=dev)
    if not out.numel():
        return out
    geno, mean, inv_std, b = _mma_operands(geno, mean, inv_std, b)
    sms = _sms(dev)
    splits = right2d_plan(d, n, ell, sms)[2]
    slab = (torch.empty((splits, d, ell), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    _launch(dev, _ENTRY[geno.dtype]["right2d"], geno, mean, inv_std, b, out, slab, d,
            _samples(geno) // 4, n, ell, b.shape[1], sms)
    return out


def _launch_right_narrow(geno, mean, inv_std, b):
    """A B (D, L) f32, L <= NARROW_MAX_L, through one C call: B cast and
    permuted on the card into `right_narrow_operand`'s order, then
    right_narrow_mma_kernel (and the sum of its slab where the plan splits
    the samples), in one workspace of the size the plan reports (read once
    per shape)."""
    d, (n, ell), dev = geno.shape[0], b.shape, geno.device
    out = torch.empty((d, ell), dtype=torch.float32, device=dev)
    if not out.numel():
        return out
    geno = aligned_rows(geno)
    width, sms = _samples(geno), _sms(dev)
    work = torch.empty(right_narrow_plan(d, width, ell, geno.dtype, sms)[4],
                       dtype=torch.uint8, device=dev)
    _launch(dev, _ENTRY[geno.dtype]["right_narrow"], geno, _aligned(mean),
            _aligned(inv_std), b, out, work, d, width // 4, n, ell, sms)
    return out


def _left2d(geno, mean, inv_std, w, precision, dtype, name):
    """A^T W through the left product of the layout `dtype`: the tensor-core
    kernel in bf16 mode (with a slab of partials where `left2d_plan` splits
    the rows), the f32 loop in f32 mode."""
    bf16 = _bf16(precision)
    geno = _check_geno(geno, dtype)
    d, dev = geno.shape[0], geno.device
    mean = _require(mean, "mean", torch.float32, (d, 1), dev)
    inv_std = _require(inv_std, "inv_std", torch.float32, (d, 1), dev)
    if w.dim() != 2 or w.shape[0] != d:
        raise ValueError(f"w must be ({d}, L), got {tuple(w.shape)}")
    w = _require(w, "w", torch.float32, w.shape, dev)
    if _route(geno) == "plain":
        return PLAIN[name](geno, mean, inv_std, w, precision)
    LAUNCHES[name] += 1
    n, ell = _samples(geno), w.shape[1]
    slab, sms = None, _sms(dev)
    if bf16:
        geno, mean, inv_std, w = _mma_operands(geno, mean, inv_std, w)
        ranges = left2d_plan(d, _samples(geno), ell, sms)[2]
        if ranges > 1:
            slab = torch.empty((ranges, _samples(geno), ell), dtype=torch.float32,
                               device=dev)
    out = torch.empty((_samples(geno), ell), dtype=torch.float32, device=dev)
    if out.numel():
        _launch(dev, _ENTRY[dtype]["left2d"], geno, mean, inv_std, w, out, slab, d,
                _samples(geno) // 4, ell, w.shape[1], int(bf16), sms)
    return out[:n]


def _right2d(geno, mean, inv_std, b, precision, dtype, name):
    """A B through the right product of the layout `dtype`: the tensor-core
    kernel in bf16 mode (with a slab of partials where `right2d_plan`
    splits the samples), the f32 loop in f32 mode."""
    geno, mean, inv_std, b = _check_common(geno, mean, inv_std, b, precision,
                                           dtype)
    if _route(geno) == "plain":
        return PLAIN[name](geno, mean, inv_std, b, precision)
    LAUNCHES[name] += 1
    if not _bf16(precision):
        return _launch_right(geno, mean, inv_std, b)
    return _launch_right2d(geno, mean, inv_std, b)


def fused_left_apply_2d_packed(packed, mean, inv_std, w, precision="bf16"):
    """A^T W: (4 * N4, L) f32, original sample order."""
    return _left2d(packed, mean, inv_std, w, precision, torch.uint8,
                   "fused_left_apply_2d_packed")


# right_apply_2d_q8 replaces pallas_kernels.py right_apply_2d_q8 (:1096,
# pallas_call :1112; body _right2d_q8_kernel :1057), both branches: packed
# input (kernel 7, _unpack_packed_tile_s8 :902) and int8 input (_clean_i8
# :1048, kernel 7i), chosen by the genotype dtype as the JAX function
# chooses.  The raw integer products G0 bq, summed exactly in int32 and
# converted to f32 once: bit for bit the plain version at every shape
# (the reference adds per-tile int32 sums in f32, which differs once a sum
# passes 2^24, about 66,000 samples).  Bound on an H100 at 65,536 x 16,384
# x 128 by the int8 tensor-core rate packed (2*D*N*L operations, 0.139 ms)
# and by its 1 GiB of bytes dense (0.331 ms).  Design
# (q8_right2d_mma_kernel, csrc/q8_right2d_kernels.cu): kernel 5's pipeline
# with int8 operands - one block per 128 rows x 128 columns loops over the
# samples in chunks of 256; a loader warp's TMA loads bring the raw packed
# half tiles (dense: the int8 rows straight into the operand ring, which a
# producer warp clamps in place to max(g, 0)) and the tiles of bq^T; a
# producer warpgroup decodes packed bytes into int8 dosages; two consumer
# warpgroups run s8 wgmma with int32 accumulators, both operands K-major,
# so the wrapper passes bq transposed (`q8_operand`, made once a call).
# Where the row blocks are fewer than the SMs (a thin strip) the samples
# split into ranges whose int32 slabs are added in a fixed order and
# converted once (`q8_right2d_plan`).  Each branch has its own launch
# count: right_apply_2d_q8 (packed), right_apply_2d_q8_i8 (int8).

_Q8_2D_NAME = {torch.uint8: ("right_apply_2d_q8", "left_apply_2d_q8"),
               torch.int8: ("right_apply_2d_q8_i8", "left_apply_2d_q8_i8")}


def q8_right2d_plan(d: int, n_samples: int, ell: int, sms: int = None) -> tuple:
    """(tile, grid, splits) of the q8 right product over `d` rows,
    `n_samples` samples and `ell` columns of bq on `sms` SMs (default: the
    current CUDA device's), as launch_q8_right2d launches it: tile (rows,
    columns), grid (row blocks, column blocks), and the ranges the samples
    split into where the blocks are fewer than the SMs (each an int32
    slab).  Read from the built library (`gp_q8_right2d_plan`)."""
    p = _library_plan("gp_q8_right2d_plan", 5, ctypes.c_int, d, n_samples, ell,
                      _current_sms(sms))
    return (p[0], p[1]), (p[2], p[3]), p[4]


def q8_pass_plan(d: int, n: int, ell: int, tile_d: int, sms: int = None) -> tuple:
    """The plans of the q8 pass (gp_q8_pass_packed / gp_q8_pass_dense) over
    `d` rows of `n` samples (the genotype rows' width), `ell` columns and
    row tiles of `tile_d` on `sms` SMs (default: the current CUDA
    device's): ((tile, grid, sample splits) of its right product, as
    `q8_right2d_plan`; (tile, grid, the first row tile of each range) of
    its left product, as `q8_left2d_plan`, the `ranges` of
    `fused_gram_q8_packed_plain` that give the card's bits; workspace
    bytes), read from the built library (`gp_q8_pass_plan`)."""
    p = _library_plan("gp_q8_pass_plan", 12, ctypes.c_longlong, d, -(-n // 4), ell,
                      tile_d, _current_sms(sms))
    return (((p[0], p[1]), (p[2], p[3]), p[4]),
            ((p[5], p[6]), (p[7], p[8]), tuple(range(0, p[9] * p[10], p[10]))), p[11])


def q8_operand(bq: torch.Tensor, samples: int = None) -> torch.Tensor:
    """bq (N, L) int8 as the q8 right product reads it: transposed, (L_pad,
    N_pad) int8 contiguous, with L padded to a multiple of 16 and N to
    `samples` (the genotype rows' width in samples; default N), rounded up
    to a multiple of 16 so that a row is whole 16-byte units; every pad
    entry 0, so that samples past the genotypes add nothing.  Without pads
    (the containers' widths, L = 128) it is one transposed copy."""
    n, ell = bq.shape
    n_pad = -(-max(n, samples or 0) // 16) * 16
    l_pad = -(-ell // 16) * 16
    if (l_pad, n_pad) == (ell, n):
        return bq.t().contiguous()
    out = torch.zeros((l_pad, n_pad), dtype=torch.int8, device=bq.device)
    out[:ell, :n] = bq.T
    return out


def right_apply_2d_q8(geno, bq):
    """G0 bq: (D, L) f32 of raw integer products; `geno` (D, N4) uint8
    packed or (D, N) int8 dense."""
    if geno.dim() != 2:
        raise ValueError(f"geno must be 2-D, got shape {tuple(geno.shape)}")
    dtype = _layout(geno)
    geno = _check_geno(geno, dtype)
    d, n, dev = geno.shape[0], _samples(geno), geno.device
    if bq.dim() != 2 or bq.shape[0] != n:
        raise ValueError(f"bq must be ({n}, L), got {tuple(bq.shape)}")
    bq = _require(bq, "bq", torch.int8, bq.shape, dev)
    if _route(geno) == "plain":
        return right_apply_2d_q8_plain(geno, bq)
    LAUNCHES[_Q8_2D_NAME[dtype][0]] += 1
    ell = bq.shape[1]
    out = torch.empty((d, ell), dtype=torch.float32, device=dev)
    if not out.numel():
        return out
    geno = aligned_rows(geno)
    bqt = q8_operand(bq, _samples(geno))
    sms = _sms(dev)
    splits = q8_right2d_plan(d, _samples(geno), ell, sms)[2]
    slab = (torch.empty((splits, d, ell), dtype=torch.int32, device=dev)
            if splits > 1 else None)
    _launch(dev, _ENTRY[dtype]["q8_right2d"], geno, bqt, out, slab, d,
            _samples(geno) // 4, ell, bqt.shape[1], sms)
    return out


# left_apply_2d_q8 replaces pallas_kernels.py left_apply_2d_q8 (:1139,
# pallas_call :1158; body _left2d_q8_kernel :1073), both branches (kernel
# 8 packed, 8i int8, counted apart): sum_t sz[t] (G0_t^T z8_t) with z8
# quantized per row tile of `tile_d`.  Bound on an H100 at 65,536 x 16,384
# x 128 by the int8 tensor-core rate packed (2*D*N*L operations, 0.139 ms)
# and by its 1 GiB of bytes dense (0.33 ms).  Design (q8_left2d_mma_kernel,
# csrc/q8_left2d_kernels.cu): kernel 7's pipeline turned over - one block
# per 128 samples x 128 columns loops over its rows in chunks of 128; a
# loader warp's TMA loads bring the raw rows and the tiles of z8^T (built
# on the card in the same C call, `q8_left_operand` states it); a producer
# warp decodes and transposes each chunk into G0^T (samples x rows); two
# consumer warpgroups run s8 wgmma into int32, one row tile at a time, and
# fold each tile into an f32 total in tile order (the plain version's
# order, bit for bit).  Where the sample blocks are fewer than the SMs the
# rows split into ranges of whole tiles whose f32 slabs are added in a
# fixed order (`q8_left2d_plan`).  On the card `tile_d` must be a multiple
# of 32 (a K step of the MMA); the plain version takes any.


def q8_left2d_plan(d: int, n_samples: int, ell: int, tile_d: int, sms: int = None) -> tuple:
    """(tile, grid, ranges, workspace bytes) of the q8 left product over
    `d` rows, `n_samples` samples (the genotype rows' width), `ell` columns
    of z8 and row tiles of `tile_d` on `sms` SMs (default: the current CUDA
    device's), as launch_q8_left2d launches it: tile (samples, columns),
    grid (sample blocks, column blocks), the first row tile of each range
    of rows (one range unless the blocks are fewer than the SMs; the
    `ranges` of `left_apply_2d_q8_plain`), and the bytes of the workspace
    the C call takes (z8^T as `q8_left_operand` gives it, padded to 256
    bytes, then the ranges' slab).  Read from the built library
    (`gp_q8_left2d_plan`)."""
    p = _library_plan("gp_q8_left2d_plan", 7, ctypes.c_longlong, d, n_samples, ell,
                      tile_d, _current_sms(sms))
    return (p[0], p[1]), (p[2], p[3]), tuple(range(0, p[4] * p[5], p[5])), p[6]


def q8_left_operand(z8: torch.Tensor) -> torch.Tensor:
    """z8 (D, L) int8 as the q8 left product reads it (built on the card
    in the same C call: by transpose_z8_kernel at the head of
    `left_apply_2d_q8`'s workspace, by the requantization kernel in the q8
    pass's; this states the layout and serves the tests): transposed,
    (L_pad, D_pad) int8 contiguous, L and D padded to multiples of 16 so
    that a row is whole 16-byte units, every pad entry 0, so that rows past
    D (whose packed bytes TMA fills with zeros, dosage 2) add nothing."""
    d, ell = z8.shape
    out = torch.zeros((-(-ell // 16) * 16, -(-d // 16) * 16), dtype=torch.int8,
                      device=z8.device)
    out[:ell, :d] = z8.T
    return out


def left_apply_2d_q8(geno, z8, sz, tile_d):
    """sum_t sz[t] G0_t^T z8_t: (N, L) f32, original sample order; `geno`
    (D, N4) uint8 packed or (D, N) int8 dense."""
    if geno.dim() != 2:
        raise ValueError(f"geno must be 2-D, got shape {tuple(geno.shape)}")
    if tile_d <= 0:
        raise ValueError(f"tile_d must be positive, got {tile_d}")
    dtype = _layout(geno)
    geno = _check_geno(geno, dtype)
    d, n, dev = geno.shape[0], _samples(geno), geno.device
    if z8.dim() != 2 or z8.shape[0] != d:
        raise ValueError(f"z8 must be ({d}, L), got {tuple(z8.shape)}")
    z8 = _require(z8, "z8", torch.int8, z8.shape, dev)
    sz = _require(sz, "sz", torch.float32, (-(-d // tile_d),), dev)
    if _route(geno) == "plain":
        return left_apply_2d_q8_plain(geno, z8, sz, tile_d)
    if tile_d % 32:
        raise ValueError(f"the q8 left kernel folds whole K steps of 32 rows: "
                         f"tile_d must be a multiple of 32, got {tile_d}")
    LAUNCHES[_Q8_2D_NAME[dtype][1]] += 1
    ell = z8.shape[1]
    if not (d and n and ell):
        return torch.zeros((n, ell), dtype=torch.float32, device=dev)
    geno, sms = aligned_rows(geno), _sms(dev)
    samples = _samples(geno)
    work = torch.empty(q8_left2d_plan(d, samples, ell, tile_d, sms)[3], dtype=torch.uint8,
                       device=dev)
    out = torch.empty((samples, ell), dtype=torch.float32, device=dev)
    _launch(dev, _ENTRY[dtype]["q8_left2d"], geno, z8, sz, out, work, d, samples // 4,
            ell, tile_d, sms)
    return out[:n]


def q8_power_pass_2d(geno, inv_std, u, bq, sb, csum, tile_d=1024):
    """The quantized power pass of the 2-D mode, as the reference's
    `q8_power_pass_2d` (pallas_kernels.py:1183-1222): kernels 7 and 8
    (packed) or 7i and 8i (int8) for the integer products, and between
    them the corrections and the per-row-tile requantization, where the
    reference leaves them to XLA.  The same function as the 1-D pass, so
    the same C call (`_launch_q8_pass`), counted as one launch of each of
    the two 2-D products.  Same argument contract and result as
    `fused_gram_q8_packed`."""
    geno, inv_std, u, bq, sb, csum = _check_q8(geno, inv_std, u, bq, sb,
                                               csum, tile_d, None)
    if _route(geno) == "plain":
        return fused_gram_q8_packed_plain(geno, inv_std, u, bq, sb, csum, tile_d)
    return _launch_q8_pass(geno, inv_std, u, bq, sb, csum, tile_d,
                           _Q8_2D_NAME[geno.dtype])


# ---------------------------------------------------------------------------
# The two exact kernels of the dense int8 2-D mode.
#
# fused_right_apply_2d replaces pallas_kernels.py fused_right_apply_2d
# (:296, pallas_call :313; body _right2d_kernel :263): A B with both axes
# tiled over (D, N) int8 dosages, bf16 operands and f32 sums, W NOT
# rounded (the reference accumulates it in f32).  Bound on an H100 by its
# D*N bytes of int8 (0.333 ms at 65,536 x 16,384; the operations take
# 0.278 ms).  Kernel 5's design (right2d_mma_kernel instantiated for
# DenseRows): each row's bf16x2 scale and shift built once a block, the
# producer's bf16x2 decode (any dosage, two bf16 roundings as the
# reference's dense tile, -127 -> 0) into the tile the wgmma consumers
# read K-major; the same sample split for thin strips.  f32 mode launches
# gp_right_dense, the f32 FMA loop.


def fused_right_apply_2d(geno, mean, inv_std, b, precision="bf16"):
    """A B over (D, N) int8 dosages: (D, L) f32, W not rounded."""
    return _right2d(geno, mean, inv_std, b, precision, torch.int8,
                    "fused_right_apply_2d")


# fused_left_apply_2d replaces pallas_kernels.py fused_left_apply_2d
# (:346, pallas_call :363; body _left2d_kernel :278): A^T W over (D, N)
# int8 dosages, W rounded to bf16 in bf16 mode.  Bound on an H100 by its
# D*N bytes of int8 (0.333 ms at 65,536 x 16,384; the operations take
# 0.278 ms).  Kernel 6's design (left2d_mma_kernel instantiated for
# DenseRows): TMA brings 128-byte rows of int8, which the producer decodes
# with bf16x2 arithmetic (any dosage, two bf16 roundings as the
# reference's dense tile, -127 -> 0) into the tile the wgmma consumers
# read; no atomics, a fixed sum order.  f32 mode keeps the f32 loop.


def fused_left_apply_2d(geno, mean, inv_std, w, precision="bf16"):
    """A^T W over (D, N) int8 dosages: (N, L) f32."""
    return _left2d(geno, mean, inv_std, w, precision, torch.int8,
                   "fused_left_apply_2d")


# standardize_runs replaces no Pallas kernel: it is the port's counterpart
# of the XLA slicers _slice_blocks_packed_impl / _slice_blocks_impl
# (genomic_pca_tpu/parallel/sharded.py:305-376), the block batches of
# EigenSNP stages 1-2 (ShardedMatrix.fetch_blocks_device).  Bound on an
# H100 by bytes: at the UK Biobank chunk (1, 512, 407,552) 834.7 MB written
# and the run's rows read (5.7 MB packed for 56 rows), 0.251 ms.  One C call
# (gp_standardize_runs_packed / _dense, csrc/block_fetch_kernels.cu) reads
# each byte of a run once and writes the f32 batch once, in the plain
# version's arithmetic, where the plain chain builds int32 and f32
# intermediates of the batch's size.


def standardize_runs(geno, mean, inv_std, starts, lens, bucket: int):
    """The (B, bucket, C) f32 block batch of `standardize_runs_plain`:
    `starts`, `lens` (B,) host integer arrays of local row runs, every
    run of nonzero length inside the D rows and at most `bucket` long
    (ValueError otherwise); the starts of zero-length runs (batch padding)
    are ignored.  Genotypes uint8 packed or int8 dense, moments (D, 1)
    f32; bit for bit the plain version.  Each launch also adds one to
    `COUNTS["block_fetch_kernel"]` (utils/profiling.py)."""
    dtype = _layout(geno)
    geno = _check_geno(geno, dtype)
    d, dev = geno.shape[0], geno.device
    mean = _require(mean, "mean", torch.float32, (d, 1), dev)
    inv_std = _require(inv_std, "inv_std", torch.float32, (d, 1), dev)
    starts = torch.as_tensor(starts, dtype=torch.int64).reshape(-1)
    lens = torch.as_tensor(lens, dtype=torch.int64).reshape(-1)
    if starts.shape != lens.shape:
        raise ValueError(f"starts {tuple(starts.shape)} and lens {tuple(lens.shape)} "
                         "must be the same length")
    if bucket < 1 or not len(lens):
        raise ValueError(f"need a bucket >= 1 and a run, got {bucket}, {len(lens)} runs")
    if int(lens.max()) > bucket:
        raise ValueError(f"block longer than bucket: {int(lens.max())} > {bucket}")
    used = lens > 0
    if bool((lens < 0).any() | (used & ((starts < 0) | (starts + lens > d))).any()):
        raise ValueError(f"a run lies outside the {d} rows")
    starts = torch.where(used, starts, 0)
    if _route(geno) == "plain":
        return standardize_runs_plain(geno, mean, inv_std, starts, lens, bucket)
    runs = torch.stack([starts, lens]).to(torch.int32).to(dev)
    out = torch.empty((len(lens), bucket, _samples(geno)), dtype=torch.float32,
                      device=dev)
    packed = dtype == torch.uint8
    LAUNCHES["standardize_runs" if packed else "standardize_runs_i8"] += 1
    count("block_fetch_kernel")
    entry = "gp_standardize_runs_packed" if packed else "gp_standardize_runs_dense"
    _launch(dev, entry, geno, mean, inv_std, runs, out, _samples(geno) // 4,
            len(lens), bucket)
    return out


# The dense 2-D products are the same functions of A as the packed ones.
fused_right_apply_2d_plain = fused_right_apply_packed_plain
fused_left_apply_2d_plain = fused_left_apply_2d_packed_plain


PLAIN = {
    "fused_gram_q8_packed": fused_gram_q8_packed_plain,
    "fused_gram_apply_packed": fused_gram_apply_packed_plain,
    "fused_tsq_packed": fused_tsq_packed_plain,
    "fused_right_apply_packed": fused_right_apply_packed_plain,
    "fused_right_apply_2d_packed": fused_right_apply_2d_packed_plain,
    "fused_left_apply_2d_packed": fused_left_apply_2d_packed_plain,
    "right_apply_2d_q8": right_apply_2d_q8_plain,
    "left_apply_2d_q8": left_apply_2d_q8_plain,
    "fused_gram_q8": fused_gram_q8_plain,
    "fused_gram_apply": fused_gram_apply_plain,
    "fused_tsq": fused_tsq_plain,
    "fused_right_apply": fused_right_apply_plain,
    "fused_right_apply_2d": fused_right_apply_2d_plain,
    "fused_left_apply_2d": fused_left_apply_2d_plain,
    "right_apply_2d_q8_i8": right_apply_2d_q8_plain,
    "left_apply_2d_q8_i8": left_apply_2d_q8_plain,
    "standardize_runs": standardize_runs_plain,
    "standardize_runs_i8": standardize_runs_plain,
}

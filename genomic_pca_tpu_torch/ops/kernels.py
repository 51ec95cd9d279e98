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
returns, un-permuted.

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
from typing import Dict

import torch

from genomic_pca_tpu_torch.ops.standardize import MISSING, standardize_rows

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


def left_apply_2d_q8_plain(geno, z8, sz, tile_d):
    """sum_t sz[t] (G0_t^T z8_t), each tile's integer product exact."""
    g_t = _row_tiles(dosages_g0(geno), tile_d)
    dt = _exact_int_dtype(2 * 127 * tile_d)
    t_int = g_t.to(dt).transpose(1, 2) @ _row_tiles(z8, tile_d).to(dt)
    return (t_int.to(torch.float32) * sz[:, None, None]).sum(dim=0)


def quantize_rows(z: torch.Tensor, tile_d: int):
    """Per-row-tile int8 quantization of z (D, L): (z8 (D, L) int8, sz (T,)
    f32) with sz = max|z| / 127 over each (tile_d, L) tile, as the
    reference's q8 passes quantize it."""
    z_t = _row_tiles(z, tile_d)
    sz = z_t.abs().amax(dim=(1, 2)) * (1.0 / 127.0) + 1e-30
    z8 = torch.clamp(torch.round(z_t * (1.0 / sz)[:, None, None]), -127.0, 127.0)
    return z8.reshape(-1, z.shape[1])[: z.shape[0]].to(torch.int8), sz


def _q8_pass(right, left, geno, inv_std, u, bq, sb, csum, tile_d):
    """One quantized power pass from its two integer products: W = G0 bq,
    the corrections y = s (W sb) - u csum and z = s y, z quantized per row
    tile, then G0^T z8 scaled per tile.  Returns (out, ru = sum u y)."""
    w = right(geno, bq)
    y = inv_std * (w * sb) - u * csum
    z = inv_std * y
    z8, sz = quantize_rows(z, tile_d)
    return left(geno, z8, sz, tile_d), (u * y).sum(dim=0, keepdim=True)


def fused_gram_q8_packed_plain(geno, inv_std, u, bq, sb, csum, tile_d=1024):
    """Plain q8 pass: the kernel's quantization model, integer products
    exact."""
    return _q8_pass(right_apply_2d_q8_plain, left_apply_2d_q8_plain, geno,
                    inv_std, u, bq, sb, csum, tile_d)


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
                  "q8_w": "gp_q8_w", "q8_left": "gp_q8_left",
                  "left2d": "gp_left2d_packed", "right2d": "gp_right2d_packed",
                  "q8_right2d": "gp_q8_right2d", "q8_left2d": "gp_q8_left2d"},
    torch.int8: {"right": "gp_right_dense", "left": "gp_left_dense",
                 "q8_w": "gp_q8_w_dense", "q8_left": "gp_q8_left_dense",
                 "left2d": "gp_left2d_dense", "right2d": "gp_right2d_dense",
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


def _launch_right(geno, mean, inv_std, b, bf16: bool, round_out: bool):
    d = geno.shape[0]
    ell = b.shape[1]
    out = torch.empty((d, ell), dtype=torch.float32, device=geno.device)
    _launch(geno.device, _ENTRY[geno.dtype]["right"], geno, mean, inv_std, b,
            out, d, _samples(geno) // 4, ell, int(bf16), int(round_out))
    return out


def _launch_gram(geno, mean, inv_std, b, bf16: bool):
    """W = A B (rounded to bf16 in bf16 mode), then A^T W split-K."""
    d, n, ell, dev = geno.shape[0], _samples(geno), b.shape[1], geno.device
    w = _launch_right(geno, mean, inv_std, b, bf16, bf16)
    out = torch.zeros((n, ell), dtype=torch.float32, device=dev)
    splits, rows = _split(dev, -(-n // 64) * -(-ell // 64), -(-d // 16), 16)
    _launch(dev, _ENTRY[geno.dtype]["left"], geno, mean, inv_std, w, out, d,
            n // 4, ell, int(bf16), splits, rows)
    return out


def _launch_tsq(geno, mean, inv_std, b, bf16: bool):
    """W = A B (rounded to bf16 in bf16 mode), then W^T W split-K."""
    d, ell = geno.shape[0], b.shape[1]
    w = _launch_right(geno, mean, inv_std, b, bf16, bf16)
    out = torch.zeros((ell, ell), dtype=torch.float32, device=geno.device)
    splits, rows = _split(geno.device, (-(-ell // 64)) ** 2, -(-d // 16), 16)
    _launch(geno.device, "gp_wtw", w, out, d, ell, splits, rows)
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


def _launch_q8(geno, inv_std, u, bq, sb, csum, tile_d):
    """The two kernels of a q8 pass: (out (N, L), ru (1, L))."""
    d, n, ell, dev = geno.shape[0], _samples(geno), bq.shape[1], geno.device
    entry = _ENTRY[geno.dtype]
    n_tiles = -(-d // tile_d)
    z = torch.empty((d, ell), dtype=torch.float32, device=dev)
    tile_max = torch.zeros(n_tiles, dtype=torch.int32, device=dev)
    ru = torch.zeros(ell, dtype=torch.float32, device=dev)
    out = torch.zeros((n, ell), dtype=torch.float32, device=dev)
    _launch(dev, entry["q8_w"], geno, inv_std, u, bq, sb, csum, z, tile_max,
            ru, d, n // 4, ell, tile_d)
    splits, per = _split(dev, -(-n // 64) * -(-ell // 64), n_tiles)
    _launch(dev, entry["q8_left"], geno, z, tile_max, out, d, n // 4, ell,
            tile_d, splits, per)
    return out, ru.reshape(1, ell)


# ---------------------------------------------------------------------------
# The four kernels of the packed 1-D mode.
#
# fused_right_apply_packed replaces genomic_pca_tpu/ops/pallas_kernels.py
# fused_right_apply_packed (:529, pallas_call :545).  On the H100 it reads
# D*N4 bytes and does 2*D*N*L operations; with L = 128 it is bound by the
# f32 FMA rate of a register-tiled loop (no tensor cores yet).  Design:
# one block per 64 x 64 output tile, decode + standardize of each byte in
# the shared-memory load, no intermediate in device memory.


def fused_right_apply_packed(packed, mean, inv_std, b, precision="bf16"):
    """A B: (D, L) f32."""
    packed, mean, inv_std, b = _check_common(packed, mean, inv_std, b, precision)
    if _route(packed) == "plain":
        return fused_right_apply_packed_plain(packed, mean, inv_std, b, precision)
    LAUNCHES["fused_right_apply_packed"] += 1
    return _launch_right(packed, mean, inv_std, b, _bf16(precision), False)


# fused_gram_apply_packed replaces pallas_kernels.py fused_gram_apply_packed
# (:492, pallas_call :508).  The TPU kernel keeps the (N, L) accumulator
# in VMEM across a sequential grid; Hopper blocks run in parallel, so the
# pass is W = A B (right kernel, W rounded to bf16 as the reference rounds
# it, kept in device memory: D*L*4 bytes) and then A^T W with the variant
# axis split across block layers and f32 atomics into the zeroed output.
# Bound by the FMA rate (4*D*N*L operations); the W round trip is 2*D*L*4
# bytes against D*N4 read twice.


def fused_gram_apply_packed(packed, mean, inv_std, b, precision="bf16"):
    """A^T (A B): (4 * N4, L) f32, original sample order."""
    packed, mean, inv_std, b = _check_common(packed, mean, inv_std, b, precision)
    if _route(packed) == "plain":
        return fused_gram_apply_packed_plain(packed, mean, inv_std, b, precision)
    LAUNCHES["fused_gram_apply_packed"] += 1
    return _launch_gram(packed, mean, inv_std, b, _bf16(precision))


# fused_tsq_packed replaces pallas_kernels.py fused_tsq_packed (:564,
# pallas_call :580).  W = A B as in the gram pass (rounded to bf16 in
# bf16 mode), then W^T W with split-K f32 atomics: 2*D*N*L + 2*D*L*L
# operations, FMA bound.


def fused_tsq_packed(packed, mean, inv_std, b, precision="bf16"):
    """(A B)^T (A B): (L, L) f32."""
    packed, mean, inv_std, b = _check_common(packed, mean, inv_std, b, precision)
    if _route(packed) == "plain":
        return fused_tsq_packed_plain(packed, mean, inv_std, b, precision)
    LAUNCHES["fused_tsq_packed"] += 1
    return _launch_tsq(packed, mean, inv_std, b, _bf16(precision))


# fused_gram_q8_packed replaces pallas_kernels.py fused_gram_q8_packed
# (:977, pallas_call :995; body _gram_q8_packed_kernel :950, decode
# _unpack_packed_tile_s8 :902).  Integer products on __dp4a (4 int8 lanes
# per instruction); bound by the dp4a issue rate at L = 128.  The per-tile
# scale max|z| over a whole (tile_d, L) tile needs a reduction before the
# second product, so the pass is two kernels (csrc/packed_common.cuh
# q8_w_kernel, q8_left_kernel): W -> y, z (D*L*4 bytes to device memory),
# ru and the tile maxima; then z8 and G0^T z8 summed exactly in int32 per
# tile, scaled, split-K f32 atomics.  `tile_d`, the quantization tile, is
# independent of the block shape.


def fused_gram_q8_packed(packed, inv_std, u, bq, sb, csum, tile_d=1024):
    """Quantized power pass: (out (4 * N4, L), ru (1, L)); the caller
    forms T = out - ru.  `bq` (4 * N4, L) int8, `sb` (1, 1), `csum` (1, L)
    as returned by ops.rsvd.quantize_basis."""
    packed, inv_std, u, bq, sb, csum = _check_q8(packed, inv_std, u, bq, sb,
                                                 csum, tile_d)
    if _route(packed) == "plain":
        return fused_gram_q8_packed_plain(packed, inv_std, u, bq, sb, csum, tile_d)
    LAUNCHES["fused_gram_q8_packed"] += 1
    return _launch_q8(packed, inv_std, u, bq, sb, csum, tile_d)


# ---------------------------------------------------------------------------
# The four kernels of the dense int8 1-D mode (csrc/dense_kernels.cu): the
# packed kernels' main loops with a loader that reads one aligned 32-bit
# word of four int8 samples per thread where the packed one reads a byte.
# Each pass reads D*N bytes, four times the packed bytes, and stays bound
# by the FMA / dp4a issue rate (2*D*N*L operations per product).
#
# fused_right_apply replaces pallas_kernels.py fused_right_apply (:181,
# pallas_call :197; body _right_kernel :112): one block per 64 x 64
# output tile, standardize in the shared-memory load.


def fused_right_apply(geno, mean, inv_std, b, precision="bf16"):
    """A B over (D, N) int8 dosages: (D, L) f32."""
    geno, mean, inv_std, b = _check_common(geno, mean, inv_std, b, precision,
                                           torch.int8)
    if _route(geno) == "plain":
        return fused_right_apply_plain(geno, mean, inv_std, b, precision)
    LAUNCHES["fused_right_apply"] += 1
    return _launch_right(geno, mean, inv_std, b, _bf16(precision), False)


# fused_gram_apply replaces pallas_kernels.py fused_gram_apply (:144,
# pallas_call :160; body _gram_kernel :95).  The TPU kernel carries the
# (N, L) accumulator through a sequential grid; here W = A B (rounded to
# bf16 as the reference rounds it) then A^T W split across block layers
# with f32 atomics.  4*D*N*L operations, FMA bound.


def fused_gram_apply(geno, mean, inv_std, b, precision="bf16"):
    """A^T (A B) over (D, N) int8 dosages: (N, L) f32."""
    geno, mean, inv_std, b = _check_common(geno, mean, inv_std, b, precision,
                                           torch.int8)
    if _route(geno) == "plain":
        return fused_gram_apply_plain(geno, mean, inv_std, b, precision)
    LAUNCHES["fused_gram_apply"] += 1
    return _launch_gram(geno, mean, inv_std, b, _bf16(precision))


# fused_tsq replaces pallas_kernels.py fused_tsq (:215, pallas_call :231;
# body _tsq_kernel :120): W = A B rounded to bf16 in bf16 mode, then
# W^T W split-K (gp_wtw).  FMA bound.


def fused_tsq(geno, mean, inv_std, b, precision="bf16"):
    """(A B)^T (A B) over (D, N) int8 dosages: (L, L) f32."""
    geno, mean, inv_std, b = _check_common(geno, mean, inv_std, b, precision,
                                           torch.int8)
    if _route(geno) == "plain":
        return fused_tsq_plain(geno, mean, inv_std, b, precision)
    LAUNCHES["fused_tsq"] += 1
    return _launch_tsq(geno, mean, inv_std, b, _bf16(precision))


# fused_gram_q8 replaces pallas_kernels.py fused_gram_q8 (:847,
# pallas_call :863; body _gram_q8_kernel :807): the packed q8 pass's two
# kernels with G0 = max(g, 0) taken per byte by __vmaxs4, so the -127
# sentinel is raw 0, and the word fed to __dp4a as it is.  dp4a bound.
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
    LAUNCHES["fused_gram_q8"] += 1
    return _launch_q8(geno, inv_std, u, bq, sb, csum, tile_d)


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
# samples x 128 columns loops over every row in chunks of 64 - no split-K,
# no atomics, a deterministic sum order.  A loader warp's TMA loads bring
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

def left2d_plan(n_samples: int, ell: int) -> tuple:
    """(tile, grid) of the tensor-core left product over `n_samples` and
    `ell` columns of W, as launch_left2d launches it: read from the built
    library (`gp_left2d_plan`), so that a log shows what the launch uses.
    The padded copy of `aligned_rows` (to 64 samples packed, 16 dense)
    never changes the grid: both divide the tile."""
    from genomic_pca_tpu_torch.ops.build import lib

    plan = (ctypes.c_int * 4)()
    lib().gp_left2d_plan(-(-n_samples // 4), ell, ctypes.addressof(plan))
    return (plan[0], plan[1]), (plan[2], plan[3])


def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def right2d_plan(d: int, n_samples: int, ell: int, sms: int = None) -> tuple:
    """(tile, grid, splits) of the tensor-core right product over `d` rows,
    `n_samples` samples and `ell` columns of B on `sms` SMs (default: the
    current CUDA device's), as launch_right2d launches it: tile (rows,
    columns), grid (row blocks, column blocks), and the ranges the samples
    split into where the blocks are fewer than the SMs.  Read from the
    built library (`gp_right2d_plan`)."""
    from genomic_pca_tpu_torch.ops.build import lib

    if sms is None:
        sms = _sms(torch.device("cuda", torch.cuda.current_device()))
    plan = (ctypes.c_int * 5)()
    lib().gp_right2d_plan(d, n_samples, ell, sms, ctypes.addressof(plan))
    return (plan[0], plan[1]), (plan[2], plan[3]), plan[4]


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


def _mma_operands(geno, mean, inv_std, x):
    """The operands of a tensor-core product as its TMA loads read them:
    `aligned_rows` of the genotypes, the moments (copied where
    misaligned), and W or B through `mma_operand`."""
    mean, inv_std = (t if t.data_ptr() % 16 == 0 else t.clone()
                     for t in (mean, inv_std))
    return aligned_rows(geno), mean, inv_std, mma_operand(x)


def _left2d(geno, mean, inv_std, w, precision, dtype, name):
    """A^T W through the left product of the layout `dtype`: the tensor-core
    kernel in bf16 mode, the f32 loop in f32 mode."""
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
    if bf16:
        geno, mean, inv_std, w = _mma_operands(geno, mean, inv_std, w)
    out = torch.empty((_samples(geno), ell), dtype=torch.float32, device=dev)
    if out.numel():
        _launch(dev, _ENTRY[dtype]["left2d"], geno, mean, inv_std, w, out, d,
                _samples(geno) // 4, ell, w.shape[1], int(bf16))
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
        return _launch_right(geno, mean, inv_std, b, False, False)
    d, (n, ell), dev = geno.shape[0], b.shape, geno.device
    out = torch.empty((d, ell), dtype=torch.float32, device=dev)
    if not out.numel():
        return out
    geno, mean, inv_std, b = _mma_operands(geno, mean, inv_std, b)
    sms = _sms(dev)
    splits = right2d_plan(d, n, ell, sms)[2]
    slab = (torch.empty((splits, d, ell), dtype=torch.float32, device=dev)
            if splits > 1 else None)
    _launch(dev, _ENTRY[dtype]["right2d"], geno, mean, inv_std, b, out, slab, d,
            _samples(geno) // 4, n, ell, b.shape[1], sms)
    return out


def fused_left_apply_2d_packed(packed, mean, inv_std, w, precision="bf16"):
    """A^T W: (4 * N4, L) f32, original sample order."""
    return _left2d(packed, mean, inv_std, w, precision, torch.uint8,
                   "fused_left_apply_2d_packed")


# right_apply_2d_q8 replaces pallas_kernels.py right_apply_2d_q8 (:1096,
# pallas_call :1112), both branches: packed input (kernel 7) and int8
# input (_clean_i8 :1048, kernel 7i), chosen by the genotype dtype as the
# JAX function chooses.  The raw integer products sum_j G0 bq on __dp4a,
# summed in int32 over the whole row and converted to f32 once (exact
# below 2^24, ~66k samples; the reference adds per-tile int32 sums in
# f32).  Bound by the dp4a instruction rate.  One block per 64 x 64
# output tile; the main loop is the one of the 1-D q8 pass (q8_right_tile
# in csrc/packed_common.cuh) without its fused corrections, which
# q8_power_pass_2d does in torch.  The int8 branch takes G0 = max(g, 0)
# of four samples at once with __vmaxs4 (DenseRows::lanes), so the -127
# sentinel is raw 0, and reads D*N bytes where the packed one reads D*N/4.
# Each branch has its own launch count: right_apply_2d_q8 (packed),
# right_apply_2d_q8_i8 (int8).

_Q8_2D_NAME = {torch.uint8: ("right_apply_2d_q8", "left_apply_2d_q8"),
               torch.int8: ("right_apply_2d_q8_i8", "left_apply_2d_q8_i8")}


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
    _launch(dev, _ENTRY[dtype]["q8_right2d"], geno, bq, out, d, n // 4, ell)
    return out


# left_apply_2d_q8 replaces pallas_kernels.py left_apply_2d_q8 (:1139,
# pallas_call :1158), both branches (kernel 8 packed, 8i int8, counted
# apart): sum_t sz[t] (G0_t^T z8_t) with z8 quantized per row tile of
# `tile_d`.  Bound by the dp4a instruction rate.  One block per (64
# samples x 64 columns) output tile loops over all row tiles: the int32
# sum of a tile is exact, and is scaled by that tile's sz and added to
# the f32 accumulator at every tile boundary (sums under different scales
# cannot be added as integers).  No atomics, fixed sum order.


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
    LAUNCHES[_Q8_2D_NAME[dtype][1]] += 1
    ell = z8.shape[1]
    out = torch.empty((n, ell), dtype=torch.float32, device=dev)
    _launch(dev, _ENTRY[dtype]["q8_left2d"], geno, z8, sz, out, d, n // 4, ell,
            tile_d)
    return out


def q8_power_pass_2d(geno, inv_std, u, bq, sb, csum, tile_d=1024):
    """The quantized power pass of the 2-D mode, as the reference's
    `q8_power_pass_2d` (pallas_kernels.py:1183-1222): kernels 7 and 8
    (packed) or 7i and 8i (int8) for the integer products, and between
    them the corrections and the per-row-tile requantization in torch on
    the small (D, L) intermediate, where the reference leaves them to XLA.
    Same argument contract and result as `fused_gram_q8_packed`."""
    geno, inv_std, u, bq, sb, csum = _check_q8(geno, inv_std, u, bq, sb,
                                               csum, tile_d, None)
    return _q8_pass(right_apply_2d_q8, left_apply_2d_q8, geno, inv_std, u,
                    bq, sb, csum, tile_d)


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
}

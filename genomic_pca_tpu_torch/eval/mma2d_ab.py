"""A/B timing of the tensor-core products between source trees, on one
GPU: the left products A^T W (kernels 6 and 14), the right products A B
(kernels 5 and 13), the 1-D gram pass A^T bf16(A B) (kernels 2 and 10),
the q8 right products G0 bq (kernels 7 and 7i), the 1-D tsq pass
bf16(A B)^T bf16(A B) (kernels 3 and 12), the 1-D right products A B
(kernels 4 and 11), the q8 left products sum_t sz[t] G0_t^T z8_t
(kernels 8 and 8i) and the 1-D q8 power pass (kernels 1 and 9).

    python -m genomic_pca_tpu_torch.eval.mma2d_ab TAG [--lines LINE ...]

Run it from the root of each tree to compare (the kernels build from that
tree's `csrc/`), alternating the trees on one card, so that they share its
clocks and power limit.  The q8, tsq and right1d lines time a tree's kernel
through its own wrapper and C calls, so they also time a tree whose
wrapper predates this script: run this file with that tree first on
PYTHONPATH,

    PYTHONPATH=<tree> python <this file> TAG --lines q8right tsq right1d q8left q8pass

It first holds each product of each layout to its plain version at small
shapes (ragged ones, for the right products a strip whose samples split,
for the left ones and the gram pass a matrix whose rows split), with a
second launch equal bit for bit (the q8 products bit for bit to plain; the
q8 left ones to 1e-5 of the tile-ordered fold, see `q8left_agrees`; the
q8 pass to 1e-5, see `q8pass_agrees`); a tree that disagrees exits 2 and
is not timed.  Then it prints these lines
(`--lines` picks some),

    [TAG] left packed <ms> dense <ms> thin packed <ms> thin dense <ms>
    [TAG] right packed <ms> dense <ms> strip packed <ms> dense <ms> thin
          packed <ms> dense <ms> L=10 packed <ms> dense <ms> fma strip
          packed <ms> dense <ms>
    [TAG] gram packed <ms> dense <ms> strip packed <ms> dense <ms> right
          packed <ms> dense <ms> left packed <ms> dense <ms> fma packed
          <ms> dense <ms> fma strip packed <ms> dense <ms>
    [TAG] q8right packed <ms> call <ms> dense <ms> call <ms> thin packed
          <ms> call <ms> dense <ms> call <ms> int_mm <ms> thin int_mm <ms>
    [TAG] tsq packed <ms> call <ms> dense <ms> call <ms> wtw <ms> fma
          packed <ms> dense <ms> multi_dot packed <ms> dense <ms>
    [TAG] right1d <layout> <D>x<N> L=<L> fma <ms> narrow <ms> wide <ms>
          call <ms> matmul <ms>        (one line a shape and width)
    [TAG] q8left <D>x<N> packed <ms> call <ms> dense <ms> call <ms> matmul
          <ms> int_mm <ms> pass packed <ms> dense <ms>   (one line a shape)
    [TAG] q8pass <D>x<N> packed <ms> call <ms> dense <ms> call <ms> int_mm2
          <ms>                                          (one line a shape)

the mean time of back-to-back launches of the C entries (the wrappers'
host work excluded: W and B already bf16, bq already transposed), L = 128
unless named: at 65,536 x 16,384 (20 launches), the left products at
2,048 x 11,264 (200), the right ones at 2,000 x 16,384 (an EigenSNP
strip, 200) and 2,048 x 11,264 (200), and at 65,536 x 16,384 with L = 10
(the loadings launch, 20).  "fma strip" is the f32 FMA loop the right
products launched before they ran on the tensor cores (gp_right_packed /
gp_right_dense in bf16 mode; the f32 mode's kernel) at 2,000 x 16,384.
The gram line times the one C call of the bf16 gram pass (gp_gram_packed /
gp_gram_dense) at the 1-D main shape 262,144 x 2,048 (20 launches) and a
streamed 1-D strip of 2,048 x 2,048 (200); its two halves alone at the
main shape, as the right product (f32 out: the same kernel and plan) and
the left product (its row split and slab sum); and the FMA pair it
replaced (the right loop rounding W, then the split-K left loop with f32
atomics; the f32 mode's kernels) at both shapes.  The q8 line times, at
65,536 x 16,384 (20) and 2,048 x 11,264 (200), the C call the wrapper
makes (replayed with the arguments it passed) and the wrapper call
itself ("call": the operand, slab and launch), and `torch._int_mm` of
the same product on decoded operands (G0 int8 row-major, bq
column-major).  The tsq line times, at the 1-D main shape 262,144 x 2,048
with L = 128 (20 launches), the C calls a wrapper call of kernel 3 / 12
makes (replayed: since the tensor-core pass, gp_tsq_packed /
gp_tsq_dense; before it, the FMA pair) and the wrapper call itself
("call"); the W^T W half alone (gp_wtw_mma on a bf16 W of 262,144 x 128;
"-" in a tree without it); the FMA pair the pass replaced (gp_right_*
rounding W to bf16, then gp_wtw split-K with f32 atomics; the f32 mode's
kernels); and `torch.linalg.multi_dot([B^T, A^T, A, B])` on A and B
already standardized and rounded to bf16.  Its check holds the pass to
a float64 W^T W over the pass's own W (`tsq_reference`): the tensor-core
right product's, or in a tree without the tsq entry (before the
tensor-core pass) the FMA right loop's.  The right1d line times kernels 4
and 11 in bf16 mode at L = 10, 16, 32 and 128 (`right1d_ms`: the FMA loop,
the narrow kernel, the 2-D kernel's f32 store, the wrapper call and
`torch.matmul`) at 262,144 x 2,048 (both layouts, 20 launches), 65,536 x
10,000 (dense, 20) and the streamed strip 2,048 x 2,048 (both, 200): the
crossover of the narrow and wide routes.  The q8left line times kernels 8
and 8i (L = 128, row tiles of 1,024) at 65,536 x 16,384 (20 launches),
the streamed strip 2,048 x 11,264 (200) and the 1-D width 262,144 x 2,048
(20): the C calls a wrapper call makes (replayed: since the tensor-core
kernel, the z8 transpose, the kernel and the sum of its row split), the
wrapper call itself ("call"), and as yardsticks on operands already
decoded `torch.matmul(G0^T, Z)` in f32 (TF32 off; Z = z8 with each row
scaled by its tile's sz: the same function up to f32 rounding) and
`torch._int_mm(G0^T, z8)` (the int8 rate, without the scales), and the
whole 2-D q8 power pass (`q8_power_pass_2d`: kernel 7 / 7i, the torch
requantization, kernel 8 / 8i; "pass").  Its check
holds the kernel to a tile-ordered fold at the plan's ranges (one range
in a tree without the plan) and prints whether it is bit for bit.  The
q8pass line times kernels 1 and 9 (L = 128, row tiles of 1,024) at the
1-D main shape 262,144 x 2,048 (20 launches) and a streamed strip of
2,048 x 2,048 (200): the C calls a wrapper call makes (replayed: since
the one-call pass gp_q8_pass_*, before it the __dp4a pair gp_q8_w* then
gp_q8_left*), the wrapper call itself ("call"), and as a yardstick only
two `torch._int_mm` on operands already decoded (G0 bq, then G0^T z8:
the pass's integer products without its scales and requantization,
"int_mm2").  Its check holds the pass's T = out - ru to the plain pass
at the plan's row ranges (one range in a tree without `q8_pass_plan`)
and prints whether `out` is bit for bit.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from genomic_pca_tpu_torch.ops import build
from genomic_pca_tpu_torch.ops import kernels as tk
from genomic_pca_tpu_torch.parallel.sharded import pack_int8_rows

NAMES = {
    ("left", "packed"): "fused_left_apply_2d_packed",
    ("left", "dense"): "fused_left_apply_2d",
    ("right", "packed"): "fused_right_apply_2d_packed",
    ("right", "dense"): "fused_right_apply_2d",
    ("gram", "packed"): "fused_gram_apply_packed",
    ("gram", "dense"): "fused_gram_apply",
    ("q8right", "packed"): "right_apply_2d_q8",
    ("q8right", "dense"): "right_apply_2d_q8_i8",
    ("tsq", "packed"): "fused_tsq_packed",
    ("tsq", "dense"): "fused_tsq",
    ("right1d", "packed"): "fused_right_apply_packed",
    ("right1d", "dense"): "fused_right_apply",
    ("q8left", "packed"): "left_apply_2d_q8",
    ("q8left", "dense"): "left_apply_2d_q8_i8",
    ("q8pass", "packed"): "fused_gram_q8_packed",
    ("q8pass", "dense"): "fused_gram_q8",
}
CHECKS = {
    "left": ((40, 256, 10), (2100, 384, 130), (4096, 1024, 128)),
    "right": ((40, 256, 10), (300, 2100, 130), (4096, 1024, 128)),
    "gram": ((40, 256, 10), (2100, 384, 130), (4096, 1024, 128)),
    "q8right": ((40, 256, 10), (300, 2100, 130), (2000, 4096, 128)),
    "tsq": ((40, 256, 10), (2100, 384, 130), (4096, 1024, 128)),
    "right1d": ((40, 256, 10), (300, 2100, 16), (2048, 2048, 10), (4096, 1024, 1),
                (4096, 1024, 32), (4096, 1024, 128)),
    "q8left": ((40, 256, 10), (300, 2100, 130), (2000, 4096, 128), (4096, 1024, 128)),
    "q8pass": ((70, 256, 10), (300, 2100, 130), (2048, 2048, 128), (4100, 2048, 128)),
}
LAYOUTS = ("packed", "dense")
# The products each printed line times (the gram line also its halves).
LINES = {"left": ("left",), "right": ("right",), "gram": ("gram", "right", "left"),
         "q8right": ("q8right",), "tsq": ("tsq",), "right1d": ("right1d",),
         "q8left": ("q8left",), "q8pass": ("q8pass",)}
# The right1d line's shapes (layout, D, N, launches) and widths: the 1-D
# main shape, the dense EigenSNP finalize's loadings and a streamed strip.
RIGHT1D_SHAPES = (("packed", 262_144, 2_048, 20), ("dense", 262_144, 2_048, 20),
                  ("dense", 65_536, 10_000, 20), ("packed", 2_048, 2_048, 200),
                  ("dense", 2_048, 2_048, 200))
RIGHT1D_ELLS = (10, 16, 32, 128)
# The q8left line's shapes (D, N, launches): the 2-D kernel shape, a
# streamed strip at the 2-D switch width and the 1-D width.
Q8LEFT_SHAPES = ((65_536, 16_384, 20), (2_048, 11_264, 200), (262_144, 2_048, 20))
Q8LEFT_TILE = 1024
# The q8pass line's shapes (D, N, launches): the 1-D main shape and a
# streamed strip.
Q8PASS_SHAPES = ((262_144, 2_048, 20), (2_048, 2_048, 200))


def agrees(product: str, layout: str, d: int, n: int, ell: int, device,
           seed: int = 0) -> bool:
    """The kernel of `product` and `layout` against its plain version to
    1e-5 of max|plain|, on dosages with 5% missing (dense: 2% outside {0,
    1, 2}), and a second launch equal bit for bit.  The gram pass rounds W
    to bf16 after a sum in another order than the plain version's, so an
    entry of W at a rounding tie may land one bf16 ulp apart: it is held
    to the plain left product of the right product's W rounded as the
    pass rounds it (`gram_reference`), whose own right half is held to
    plain; the tsq pass likewise to a float64 W^T W of that W
    (`tsq_reference`)."""
    rng = np.random.default_rng(seed)
    if product == "q8right":
        return q8right_agrees(layout, d, n, ell, device, rng)
    if product == "q8left":
        return q8left_agrees(layout, d, n, ell, device, rng)
    if product == "q8pass":
        return q8pass_agrees(layout, d, n, ell, device, rng)
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    if layout == "dense":
        odd = rng.random(g.shape) < 0.02
        g[odd] = rng.integers(-100, 100, size=int(odd.sum()))
    g[rng.random(g.shape) < 0.05] = -127
    mu = rng.uniform(0.2, 1.8, size=(d, 1)).astype(np.float32)
    inv = rng.uniform(0.5, 2.0, size=(d, 1)).astype(np.float32)
    geno = pack_int8_rows(g) if layout == "packed" else g
    k = d if product == "left" else 4 * -(-n // 4)
    x = rng.standard_normal((k, ell)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device)
            for a in (geno, mu, inv, x)]
    name = NAMES[product, layout]
    kernel = getattr(tk, name)
    got, again = kernel(*args), kernel(*args)
    w_err, fma = 0.0, False
    if product == "gram":
        ref, w_err, _ = gram_reference(*args)
    elif product == "tsq":
        # Before the tensor-core pass: the FMA pair, whose W^T W adds with f32
        # atomics, so its bits may change from launch to launch.
        fma = "gp_tsq_packed" not in build.SIGNATURES and device.type == "cuda"
        ref, w_err, _, _ = tsq_reference(*args, fma=fma)
    else:
        ref = tk.PLAIN[name](*args, "bf16")
    err = float((got.double() - ref).abs().max()) / float(ref.abs().max())
    return max(err, w_err) <= 1e-5 and (fma or bool(torch.equal(got, again)))


def q8right_agrees(layout: str, d: int, n: int, ell: int, device, rng) -> bool:
    """Kernel 7 or 7i against its plain version bit for bit (exact integer
    sums), on dosages {0, 1, 2} with 5% missing and a random bq, and a
    second launch equal bit for bit."""
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -127
    geno = pack_int8_rows(g) if layout == "packed" else g
    bq = rng.integers(-127, 128, size=(4 * -(-n // 4), ell)).astype(np.int8)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (geno, bq)]
    got, again = tk.right_apply_2d_q8(*args), tk.right_apply_2d_q8(*args)
    ref = tk.PLAIN[NAMES["q8right", layout]](*args)
    return bool(torch.equal(got, ref)) and bool(torch.equal(got, again))


def tile_ordered(geno, z8, sz, tile_d, ranges=(0,)):
    """sum_t sz[t] G0_t^T z8_t folded in tile order from zeros (f32, one
    rounding a multiply and one an add), each range of row tiles apart and
    the ranges added in order: the order of `left_apply_2d_q8_plain` since
    the tensor-core kernel, written out here so that an older tree, whose
    plain version sums the tiles in torch's order, is held to it too."""
    g0 = tk.dosages_g0(geno).to(torch.float32)
    d = g0.shape[0]
    bounds = [*ranges, -(-d // tile_d)]
    total = None
    for lo, hi in zip(bounds, bounds[1:]):
        part = torch.zeros((g0.shape[1], z8.shape[1]), device=geno.device)
        for t in range(lo, hi):
            rows = slice(t * tile_d, min(d, (t + 1) * tile_d))
            part = part + (g0[rows].T @ z8[rows].to(torch.float32)) * sz[t]
        total = part if total is None else total + part
    return total


def q8left_agrees(layout: str, d: int, n: int, ell: int, device, rng,
                  tile_d: int = 64) -> bool:
    """Kernel 8 or 8i against `tile_ordered` at the plan's row ranges (one
    range on the CPU or in a tree without `q8_left2d_plan`) to 1e-5 of
    max|ref|, on dosages {0, 1, 2} with 5% missing, a random z8 and
    scales, and a second launch equal bit for bit; prints whether the
    kernel is bit for bit."""
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -127
    geno = pack_int8_rows(g) if layout == "packed" else g
    z8 = rng.integers(-127, 128, size=(d, ell)).astype(np.int8)
    sz = rng.uniform(0.01, 0.1, size=-(-d // tile_d)).astype(np.float32)
    args = [torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in (geno, z8, sz)]
    got, again = (tk.left_apply_2d_q8(*args, tile_d), tk.left_apply_2d_q8(*args, tile_d))
    ranges = (0,)
    if device.type == "cuda" and hasattr(tk, "q8_left2d_plan"):
        ranges = tk.q8_left2d_plan(d, tk._samples(tk.aligned_rows(args[0])), ell,
                                   tile_d)[2]
    ref = tile_ordered(*args, tile_d, ranges)[: got.shape[0]]
    exact = bool(torch.equal(got, ref))
    print(f"q8left {layout} D={d} N={n} L={ell} tile {tile_d} ranges {len(ranges)}: "
          f"bit for bit {exact}", flush=True)
    err = float((got - ref).abs().max()) / max(float(ref.abs().max()), 1e-30)
    return err <= 1e-5 and bool(torch.equal(got, again))


def q8_pass_args(g, device, rng, ell: int):
    """(genotypes, inv_std, u, bq, sb, csum) of a q8 pass over the dosages
    `g` (packed if uint8) on `device`: random moments and a random basis
    quantized as the power loop quantizes it."""
    from genomic_pca_tpu_torch.ops.rsvd import quantize_basis

    d = g.shape[0]
    n = 4 * g.shape[1] if g.dtype == np.uint8 else g.shape[1]
    iv = rng.uniform(0.5, 2.0, (d, 1)).astype(np.float32)
    u = rng.uniform(0.0, 2.0, (d, 1)).astype(np.float32)
    b = rng.standard_normal((n, ell)).astype(np.float32) / n ** 0.5
    geno, iv, u, b = (torch.from_numpy(np.ascontiguousarray(a)).to(device)
                      for a in (g, iv, u, b))
    return (geno, iv, u, *quantize_basis(b))


def q8pass_agrees(layout: str, d: int, n: int, ell: int, device, rng,
                  tile_d: int = 64) -> bool:
    """Kernel 1 or 9 against the plain pass at the plan's row ranges (one
    range on the CPU or in a tree without `q8_pass_plan`): T = out - ru to
    1e-5 of max|T|, on dosages {0, 1, 2} with 5% missing, and, in a tree
    with the plan (no atomics), a second launch equal bit for bit; prints
    whether `out` is bit for bit."""
    g = rng.integers(0, 3, size=(d, n)).astype(np.int8)
    g[rng.random(g.shape) < 0.05] = -127
    args = q8_pass_args(pack_int8_rows(g) if layout == "packed" else g, device, rng, ell)
    name = NAMES["q8pass", layout]
    fn, plain = getattr(tk, name), tk.PLAIN[name]
    (out, ru), (out2, ru2) = fn(*args, tile_d=tile_d), fn(*args, tile_d=tile_d)
    planned = device.type == "cuda" and hasattr(tk, "q8_pass_plan")
    kw = {}
    if planned:
        kw["ranges"] = tk.q8_pass_plan(d, tk._samples(tk.aligned_rows(args[0])), ell,
                                       tile_d)[1][2]
    out_p, ru_p = plain(*args, tile_d=tile_d, **kw)
    print(f"q8pass {layout} D={d} N={n} L={ell} tile {tile_d} ranges "
          f"{len(kw.get('ranges', (0,)))}: out bit for bit {bool(torch.equal(out, out_p))}",
          flush=True)
    t, t_p = out - ru, out_p - ru_p
    err = float((t - t_p).abs().max()) / max(float(t_p.abs().max()), 1e-30)
    repeats = bool(torch.equal(out, out2)) and bool(torch.equal(ru, ru2))
    return err <= 1e-5 and (repeats or not planned)


def pass_w(geno, mean, inv_std, b, fma: bool = False):
    """The W of the bf16 gram and tsq passes on the inputs of a call: (the
    right product's f32 W from its tensor-core kernel - the passes' own
    sum order and plan, so that their bf16 W is this W rounded once; with
    `fma` from the FMA right loop, kernel 4 / 11, which a tree's tsq pass
    rounded before the tensor-core pass -, that W's error against the
    plain right product relative to max|plain|, the plain W rounded to
    bf16, the differences of the W entries whose bf16 rounding differs
    from the plain W's).  On the CPU both W are the plain version's."""
    packed = geno.dtype == torch.uint8
    right = ((tk.fused_right_apply_packed if packed else tk.fused_right_apply) if fma
             else tk.fused_right_apply_2d_packed if packed else tk.fused_right_apply_2d)
    w, w_plain = right(geno, mean, inv_std, b), tk.fused_right_apply_packed_plain(
        geno, mean, inv_std, b)
    w_err = float((w - w_plain).abs().max()) / float(w_plain.abs().max())
    w_plain = tk._round_bf16(w_plain)
    return w, w_err, w_plain, tk._round_bf16(w) - w_plain


def gram_reference(geno, mean, inv_std, b):
    """The bf16 gram pass's reference on the inputs of a call: (the plain
    left product of the pass's W rounded to bf16, W's error against the
    plain right product, the W ties; see `pass_w`)."""
    w, w_err, _, ties = pass_w(geno, mean, inv_std, b)
    ref = tk.fused_left_apply_2d_packed_plain(geno, mean, inv_std, tk._round_bf16(w))
    return ref, w_err, ties


def tsq_reference(geno, mean, inv_std, b, fma: bool = False):
    """The bf16 tsq pass's reference on the inputs of a call: (the float64
    W^T W of the pass's W rounded to bf16, W's error against the plain
    right product, the W ties (see `pass_w`), and entry by entry |dW|^T
    |W| + |W|^T |dW|, |W| the larger of the two bf16 W: how far the pass
    may lie from the plain tsq through W's ties)."""
    w, w_err, w_plain, ties = pass_w(geno, mean, inv_std, b, fma)
    wb = tk._round_bf16(w).double()
    aw, dw = torch.maximum(wb.abs(), w_plain.double().abs()), ties.double().abs()
    return wb.T @ wb, w_err, ties, dw.T @ aw + aw.T @ dw


def operands(layout: str, d: int, n: int, ell: int = 128) -> tuple:
    """(genotypes, mean, inv_std, b) of a product at D x N on the card:
    random bytes (the time does not depend on the genotypes)."""
    dev = torch.device("cuda")
    if layout == "packed":
        g = torch.randint(0, 256, (d, n // 4), device=dev, dtype=torch.uint8)
    else:
        g = torch.randint(0, 3, (d, n), device=dev, dtype=torch.int8)
    return (g, torch.rand((d, 1), device=dev), torch.rand((d, 1), device=dev) + 0.5,
            torch.randn((n, ell), device=dev) / n ** 0.5)


def launch_ms(product: str, layout: str, d: int, n: int, reps: int,
              ell: int = 128, fma: bool = False) -> float:
    """Mean ms of `reps` back-to-back launches of the C entry on random
    bytes (the time does not depend on the genotypes); `fma`: the right
    product's f32 FMA loop in bf16 mode, or the gram pass's FMA pair."""
    if fma and product == "gram":
        return fma_gram_ms(layout, d, n, reps, ell)
    g, mean, inv, _ = operands(layout, d, n, ell)
    dev = g.device
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.lib()
    sms = tk._sms(dev)
    if product == "left":
        x = torch.randn((d, ell), device=dev)
        out = torch.empty((n, ell), device=dev)
        entry = getattr(lib, tk._ENTRY[g.dtype]["left2d"])
        ranges = tk.left2d_plan(d, n, ell, sms)[2]
        slab = torch.empty((ranges, n, ell), device=dev) if ranges > 1 else None
        args = [x.to(torch.bfloat16), out, slab, d, n // 4, ell, ell, 1, sms]
    elif product == "gram":
        b = tk.mma_operand(torch.randn((n, ell), device=dev))
        out = torch.empty((n, ell), device=dev)
        work = torch.empty(tk.gram_plan(d, n // 4, n, ell, sms)[2],
                           dtype=torch.uint8, device=dev)
        entry = getattr(lib, tk._ENTRY[g.dtype]["gram"])
        args = [b, out, work, d, n // 4, n, ell, b.shape[1], sms]
    else:
        x = torch.randn((n, ell), device=dev)
        out = torch.empty((d, ell), device=dev)
        if fma:
            entry = getattr(lib, tk._ENTRY[g.dtype]["right"])
            args = [x, out, d, n // 4, ell, 1, 0]
        else:
            entry = getattr(lib, tk._ENTRY[g.dtype]["right2d"])
            b = tk.mma_operand(x)
            splits = tk.right2d_plan(d, n, ell, sms)[2]
            slab = torch.empty((splits, d, ell), device=dev) if splits > 1 else None
            args = [b, out, slab, d, n // 4, n, ell, b.shape[1], sms]
    args = [a.data_ptr() if torch.is_tensor(a) else a
            for a in [g, mean, inv, *args, stream]]

    def once():
        if entry(*args) != 0:
            raise RuntimeError(f"{product} {layout} refused the launch")

    return mean_ms(once, reps)


def mean_ms(fn, reps: int) -> float:
    """Mean ms of `reps` back-to-back calls of `fn` after three warm-up
    calls, by CUDA events around the run."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def captured_launches(fn, *args) -> list:
    """[(C entry, its arguments)] of the C calls `fn(*args)` makes through
    `kernels._launch`, in order; the tensors among the arguments stay
    alive with the list."""
    seen, real = [], tk._launch

    def spy(device, entry, *call):
        seen.append((entry, call))
        real(device, entry, *call)

    tk._launch = spy
    try:
        fn(*args)
    finally:
        tk._launch = real
    return seen


def replay_ms(calls, reps: int, label: str) -> float:
    """Mean ms of `reps` back-to-back replays of the C calls `calls` (as
    `captured_launches` gives them)."""
    lib = build.lib()
    stream = torch.cuda.current_stream().cuda_stream
    fns = [(getattr(lib, entry), [a.data_ptr() if torch.is_tensor(a) else a
                                  for a in (*args, stream)]) for entry, args in calls]

    def once():
        for fn, ptrs in fns:
            if fn(*ptrs) != 0:
                raise RuntimeError(f"{label} refused the launch")

    return mean_ms(once, reps)


def q8right_ms(layout: str, d: int, n: int, reps: int, call: bool) -> float:
    """Mean ms of `reps` back-to-back q8 right products G0 bq (L = 128):
    the C call the wrapper makes, replayed with the arguments it passed,
    or (`call`) the wrapper itself."""
    g = operands(layout, d, n)[0]
    bq = torch.randint(-127, 128, (n, 128), device=g.device, dtype=torch.int8)
    if call:
        return mean_ms(lambda: tk.right_apply_2d_q8(g, bq), reps)
    return replay_ms(captured_launches(tk.right_apply_2d_q8, g, bq), reps,
                     f"q8right {layout}")


def tsq_ms(layout: str, d: int, n: int, reps: int, call: bool) -> float:
    """Mean ms of `reps` back-to-back bf16 tsq passes (L = 128): the C
    calls a wrapper call makes, replayed with the arguments it passed, or
    (`call`) the wrapper itself."""
    args = operands(layout, d, n)
    fn = tk.fused_tsq_packed if layout == "packed" else tk.fused_tsq
    if call:
        return mean_ms(lambda: fn(*args), reps)
    return replay_ms(captured_launches(fn, *args), reps, f"tsq {layout}")


def wtw_ms(d: int, reps: int, ell: int = 128):
    """Mean ms of `reps` back-to-back W^T W halves of the tsq pass
    (gp_wtw_mma, with its row slab) on a bf16 W (D, ell); None in a tree
    without it."""
    if "gp_wtw_mma" not in build.SIGNATURES:
        return None
    dev = torch.device("cuda")
    sms = tk._sms(dev)
    w = torch.randn((d, ell), device=dev).to(torch.bfloat16)
    out = torch.empty((ell, ell), device=dev)
    ranges = tk.tsq_plan(d, 1, 1, ell, sms)[1][2]
    slab = torch.empty((ranges, ell, ell), device=dev) if ranges > 1 else None
    return replay_ms([("gp_wtw_mma", (w, out, slab, d, ell, ell, sms))], reps, "wtw")


def fma_tsq_ms(layout: str, d: int, n: int, reps: int, ell: int = 128) -> float:
    """Mean ms of `reps` back-to-back bf16 tsq passes through the FMA pair
    the tensor-core pass replaced: gp_right_* rounding W to bf16 (f32
    storage), then gp_wtw split-K, as the pass's wrapper launched them."""
    g, mean, inv, b = operands(layout, d, n, ell)
    dev = g.device
    w = torch.empty((d, ell), device=dev)
    out = torch.zeros((ell, ell), device=dev)
    splits, rows = tk._split(dev, (-(-ell // 64)) ** 2, -(-d // 16), 16)
    return replay_ms([(tk._ENTRY[g.dtype]["right"], (g, mean, inv, b, w, d, n // 4,
                                                      ell, 1, 1)),
                      ("gp_wtw", (w, out, d, ell, splits, rows))], reps,
                     f"tsq {layout}: the FMA pair")


def multi_dot_ms(layout: str, d: int, n: int, reps: int) -> float:
    """Mean ms of `torch.linalg.multi_dot([B^T, A^T, A, B])` at D x N, L =
    128, on A and B already standardized and rounded to bf16.  A
    yardstick only: the port never calls it."""
    g, mean, inv, b = operands(layout, d, n)
    a = tk.standardize(g, mean, inv, "bf16").to(torch.bfloat16)
    b = b.to(torch.bfloat16)
    at, bt = a.t(), b.t()
    return mean_ms(lambda: torch.linalg.multi_dot([bt, at, a, b]), reps)


def right1d_ms(layout: str, d: int, n: int, ell: int, reps: int) -> dict:
    """Mean ms of `reps` back-to-back 1-D right products A B (kernels 4 and
    11, bf16) at D x N x `ell` on random bytes: "fma" the f32 FMA loop
    (gp_right_* in bf16 mode), "narrow" the C call of right_narrow_mma_kernel
    a wrapper call makes (None in a tree without it), "wide" the C call of
    right2d_mma_kernel's f32 store (the 2-D wrapper's), each replayed with
    the arguments it was given; "call" the 1-D wrapper itself; "matmul"
    `torch.matmul(A, B)` on A and B already standardized and rounded to
    bf16 (a yardstick only: the port never calls it)."""
    g, mean, inv, b = operands(layout, d, n, ell)
    packed = layout == "packed"
    out = torch.empty((d, ell), device=g.device)
    ms = {"fma": replay_ms([(tk._ENTRY[g.dtype]["right"],
                             (g, mean, inv, b, out, d, n // 4, ell, 1, 0))], reps,
                           f"right1d {layout}: the FMA loop")}
    ms["narrow"] = (replay_ms(captured_launches(tk._launch_right_narrow, g, mean, inv, b),
                              reps, f"right1d {layout}: narrow")
                    if "gp_right_narrow_packed" in build.SIGNATURES else None)
    wide = tk.fused_right_apply_2d_packed if packed else tk.fused_right_apply_2d
    ms["wide"] = replay_ms(captured_launches(wide, g, mean, inv, b), reps,
                           f"right1d {layout}: wide")
    fn = tk.fused_right_apply_packed if packed else tk.fused_right_apply
    ms["call"] = mean_ms(lambda: fn(g, mean, inv, b), reps)
    a = tk.standardize(g, mean, inv, "bf16").to(torch.bfloat16)
    bb = b.to(torch.bfloat16)
    ms["matmul"] = mean_ms(lambda: torch.matmul(a, bb), reps)
    return ms


def q8left_ms(layout: str, d: int, n: int, reps: int, call: bool) -> float:
    """Mean ms of `reps` back-to-back q8 left products (L = 128, row tiles
    of Q8LEFT_TILE): the C calls a wrapper call makes, replayed with the
    arguments it passed, or (`call`) the wrapper itself."""
    g = operands(layout, d, n)[0]
    z8 = torch.randint(-127, 128, (d, 128), device=g.device, dtype=torch.int8)
    sz = torch.rand(-(-d // Q8LEFT_TILE), device=g.device) + 0.01
    if call:
        return mean_ms(lambda: tk.left_apply_2d_q8(g, z8, sz, Q8LEFT_TILE), reps)
    return replay_ms(captured_launches(tk.left_apply_2d_q8, g, z8, sz, Q8LEFT_TILE),
                     reps, f"q8left {layout}")


def q8left_library_ms(d: int, n: int, reps: int) -> tuple:
    """Mean ms of `torch.matmul(G0^T, Z)` in f32 with TF32 off (Z = z8 with
    each row scaled by its tile's sz: the q8 left product up to f32
    rounding) and of `torch._int_mm(G0^T, z8)` (int8, G0^T row-major, z8
    column-major, without the scales), on operands already decoded.
    Yardsticks only: the port never calls them."""
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g0t = torch.randint(0, 3, (n, d), device=dev, dtype=torch.int8)
    z8 = torch.randint(-127, 128, (128, d), device=dev, dtype=torch.int8).t()
    sz = torch.rand(-(-d // Q8LEFT_TILE), device=dev) + 0.01
    a = g0t.to(torch.float32)
    z = z8.to(torch.float32) * sz.repeat_interleave(Q8LEFT_TILE)[:d, None]
    mm = mean_ms(lambda: torch.matmul(a, z), reps)
    del a, z
    return mm, mean_ms(lambda: torch._int_mm(g0t, z8), reps)


def q8pass_ms(layout: str, d: int, n: int, reps: int) -> float:
    """Mean ms of `reps` back-to-back 2-D q8 power passes
    (`q8_power_pass_2d`, L = 128, row tiles of Q8LEFT_TILE) on random
    bytes and a random basis."""
    from genomic_pca_tpu_torch.ops.rsvd import quantize_basis

    g, mean, inv, b = operands(layout, d, n)
    bq, sb, csum = quantize_basis(b)
    u = mean * inv
    return mean_ms(lambda: tk.q8_power_pass_2d(g, inv, u, bq, sb, csum,
                                               tile_d=Q8LEFT_TILE), reps)


def q8pass1d_ms(layout: str, d: int, n: int, reps: int, call: bool) -> float:
    """Mean ms of `reps` back-to-back 1-D q8 passes (kernels 1 / 9, L =
    128, row tiles of Q8LEFT_TILE) on random bytes: the C calls a wrapper
    call makes, replayed with the arguments it passed, or (`call`) the
    wrapper itself."""
    g = operands(layout, d, n)[0]
    args = q8_pass_args(g.cpu().numpy(), g.device, np.random.default_rng(0), 128)
    fn = getattr(tk, NAMES["q8pass", layout])
    if call:
        return mean_ms(lambda: fn(*args, tile_d=Q8LEFT_TILE), reps)
    return replay_ms(captured_launches(lambda: fn(*args, tile_d=Q8LEFT_TILE)), reps,
                     f"q8pass {layout}")


def int_mm2_ms(d: int, n: int, reps: int) -> float:
    """Mean ms of `torch._int_mm(G0, bq)` then `torch._int_mm(G0^T, z8)` at
    D x N, L = 128, on operands already decoded (the row-major left operand
    and the column-major right one cuBLASLt takes): the q8 pass's two
    integer products without its scales and requantization.  A yardstick
    only: the port never calls it."""
    dev = torch.device("cuda")
    g0 = torch.randint(0, 3, (d, n), device=dev, dtype=torch.int8)
    g0t = g0.t().contiguous()
    bq = torch.randint(-127, 128, (128, n), device=dev, dtype=torch.int8).t()
    z8 = torch.randint(-127, 128, (128, d), device=dev, dtype=torch.int8).t()
    return mean_ms(lambda: (torch._int_mm(g0, bq), torch._int_mm(g0t, z8)), reps)


def int_mm_ms(d: int, n: int, reps: int) -> float:
    """Mean ms of `torch._int_mm(G0, bq)` at D x N, L = 128, on operands
    already decoded: G0 int8 row-major, bq int8 column-major (as cuBLASLt
    takes it).  A yardstick only: the port never calls it."""
    dev = torch.device("cuda")
    g0 = torch.randint(0, 3, (d, n), device=dev, dtype=torch.int8)
    bq = torch.randint(-127, 128, (128, n), device=dev, dtype=torch.int8).t()
    return mean_ms(lambda: torch._int_mm(g0, bq), reps)


def fma_gram_ms(layout: str, d: int, n: int, reps: int, ell: int = 128) -> float:
    """Mean ms of `reps` back-to-back bf16 gram passes through the FMA pair
    the tensor-core pass replaced: gp_right_* rounding W to bf16 (f32
    storage), then gp_left_* split-K into a zeroed output, as the pass's
    wrapper launched them."""
    g, mean, inv, b = operands(layout, d, n, ell)
    dev = g.device
    w = torch.empty((d, ell), device=dev)
    out = torch.zeros((n, ell), device=dev)
    stream = torch.cuda.current_stream().cuda_stream
    lib = build.lib()
    right = getattr(lib, tk._ENTRY[g.dtype]["right"])
    left = getattr(lib, tk._ENTRY[g.dtype]["left"])
    splits, rows = tk._split(dev, -(-n // 64) * -(-ell // 64), -(-d // 16), 16)
    p = [t.data_ptr() for t in (g, mean, inv)]

    def once():
        rc = right(*p, b.data_ptr(), w.data_ptr(), d, n // 4, ell, 1, 1, stream)
        rc |= left(*p, w.data_ptr(), out.data_ptr(), d, n // 4, ell, 1, splits,
                   rows, stream)
        if rc != 0:
            raise RuntimeError(f"gram {layout}: the FMA pair refused the launch")

    return mean_ms(once, reps)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("tag")
    ap.add_argument("--lines", nargs="+", choices=tuple(LINES), default=tuple(LINES),
                    help="the lines to check and time (default: all)")
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("mma2d_ab needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    products = {p for line in a.lines for p in LINES[line]}
    bad = [(prod, lay, *shape) for prod, lay in NAMES if prod in products
           for shape in CHECKS[prod] if not agrees(prod, lay, *shape, dev)]
    for prod, lay, d, n, ell in bad:
        print(f"[{a.tag}] FAIL {prod} {lay} D={d} N={n} L={ell}", flush=True)
    if bad:
        return 2

    def each(product, d, n, reps, **kw):
        return " ".join(f"{lay} {launch_ms(product, lay, d, n, reps, **kw):.4f}"
                        for lay in LAYOUTS)

    def each_q8(d, n, reps):
        return " ".join(f"{lay} {q8right_ms(lay, d, n, reps, False):.4f} call "
                        f"{q8right_ms(lay, d, n, reps, True):.4f}" for lay in LAYOUTS)

    if "left" in a.lines:
        print(f"[{a.tag}] left {each('left', 65_536, 16_384, 20)} "
              f"thin {each('left', 2_048, 11_264, 200)}", flush=True)
    if "right" in a.lines:
        print(f"[{a.tag}] right {each('right', 65_536, 16_384, 20)} "
              f"strip {each('right', 2_000, 16_384, 200)} "
              f"thin {each('right', 2_048, 11_264, 200)} "
              f"L=10 {each('right', 65_536, 16_384, 20, ell=10)} "
              f"fma strip {each('right', 2_000, 16_384, 20, fma=True)}", flush=True)
    if "gram" in a.lines:
        print(f"[{a.tag}] gram {each('gram', 262_144, 2_048, 20)} "
              f"strip {each('gram', 2_048, 2_048, 200)} "
              f"right {each('right', 262_144, 2_048, 20)} "
              f"left {each('left', 262_144, 2_048, 20)} "
              f"fma {each('gram', 262_144, 2_048, 5, fma=True)} "
              f"fma strip {each('gram', 2_048, 2_048, 50, fma=True)}", flush=True)
    if "q8right" in a.lines:
        print(f"[{a.tag}] q8right {each_q8(65_536, 16_384, 20)} "
              f"thin {each_q8(2_048, 11_264, 200)} "
              f"int_mm {int_mm_ms(65_536, 16_384, 20):.4f} "
              f"thin int_mm {int_mm_ms(2_048, 11_264, 200):.4f}", flush=True)
    if "tsq" in a.lines:
        d, n = 262_144, 2_048
        calls = " ".join(f"{lay} {tsq_ms(lay, d, n, 20, False):.4f} call "
                         f"{tsq_ms(lay, d, n, 20, True):.4f}" for lay in LAYOUTS)
        wtw = wtw_ms(d, 20)
        fma = " ".join(f"{lay} {fma_tsq_ms(lay, d, n, 5):.4f}" for lay in LAYOUTS)
        dots = " ".join(f"{lay} {multi_dot_ms(lay, d, n, 20):.4f}" for lay in LAYOUTS)
        print(f"[{a.tag}] tsq {calls} wtw {'-' if wtw is None else f'{wtw:.4f}'} "
              f"fma {fma} multi_dot {dots}", flush=True)
    if "q8left" in a.lines:
        for d, n, reps in Q8LEFT_SHAPES:
            calls = " ".join(f"{lay} {q8left_ms(lay, d, n, reps, False):.4f} call "
                             f"{q8left_ms(lay, d, n, reps, True):.4f}" for lay in LAYOUTS)
            mm, imm = q8left_library_ms(d, n, reps)
            passes = " ".join(f"{lay} {q8pass_ms(lay, d, n, reps):.4f}" for lay in LAYOUTS)
            print(f"[{a.tag}] q8left {d}x{n} {calls} matmul {mm:.4f} int_mm {imm:.4f} "
                  f"pass {passes}", flush=True)
    if "q8pass" in a.lines:
        for d, n, reps in Q8PASS_SHAPES:
            calls = " ".join(f"{lay} {q8pass1d_ms(lay, d, n, reps, False):.4f} call "
                             f"{q8pass1d_ms(lay, d, n, reps, True):.4f}" for lay in LAYOUTS)
            print(f"[{a.tag}] q8pass {d}x{n} {calls} int_mm2 "
                  f"{int_mm2_ms(d, n, reps):.4f}", flush=True)
    if "right1d" in a.lines:
        for layout, d, n, reps in RIGHT1D_SHAPES:
            for ell in RIGHT1D_ELLS:
                ms = right1d_ms(layout, d, n, ell, reps)
                print(f"[{a.tag}] right1d {layout} {d}x{n} L={ell} " + " ".join(
                    f"{k} {'-' if v is None else f'{v:.4f}'}" for k, v in ms.items()),
                    flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Smoke run of the PyTorch + CUDA port on one GPU: `python3 chip_smoke.py`.

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. toolchain: the card's name and power limit, CUDA, nvcc, triton;
2. build the hand-written kernels from genomic_pca_tpu_torch/csrc/;
3. the four 1-D kernels against their plain PyTorch versions on the
   card, at the 1-D main path's shapes (262,144 SNPs x 2,048 samples,
   L = 128; L = k = 10 for the loadings product) and at a ragged shape
   (70,001 x 2,504), with CUDA-event median times of kernel and plain
   version;
4. the four 2-D (wide-sample) kernels the same way at 65,536 x 16,384,
   L = 128, and at 70,001 x 16,389; kernels 5 and 6 at 2,048 x 11,264 (a
   streamed strip at the 2-D switch width: their thinnest grids), 5 at
   2,000 x 16,384 (an EigenSNP strip, whose samples split) and at 65,536
   x 16,384 with L = 10 (the loadings launch), each tensor-core product
   with its tile, grid (and sample split) and a bit-identical second
   launch; the 1-D gram and q8 passes against the 2-D ones at the wide
   shape; `q8_power_pass_2d` against a float64 replay of its quantization
   model;
5. the 1-D main path, `streamed_pca(ShardedMatrix.from_packed_rows(...),
   k=10, n_power_iter=4, compute_loadings=True)` over structured
   genotypes of 262,144 x 2,048: launch counts 3 / 1 / 1 / 1 for q8 /
   gram / tsq / right and none of the 2-D kernels; PCs and eigenvalues
   against a float64 PCA on the card;
6. the 2-D main path, the same call at 131,072 x 16,384 (512 MiB packed):
   3 q8 passes through kernels 7 and 8, the exact polish, tsq and
   loadings through 5 and 6, none of 1-4; the same float64 gate;
7. the VCF CLI, `python -m genomic_pca_tpu_torch -d <dir> -o <prefix>
   -k 10`, on two generated multi-file VCF directories of 2,504 samples
   (32,768 variants of 5 populations, 65,536 of 11);
8. the EigenSNP CLI, `python -m genomic_pca_tpu_torch --eigensnp
   --bed-file ... --ld-block-file ... -o ...` at its default settings on
   a PLINK fileset of 65,536 SNPs x 16,384 samples in 64 LD blocks, made
   on the card; its stage split and launch counts (5 and 6 ran), and its
   TSVs against a float64 PCA of the PCA-SNP set it kept;
9. the four dense int8 kernels (9-12) against their plain versions at
   262,144 x 2,048 (L = 128; 10 for the right product) and at 70,001 x
   2,504 (container width 2,560), and the exact three (10-12) at 65,536
   x 10,000 (container width 10,112), the width of phase 11;
10. the dense main path, `streamed_pca(ShardedMatrix.from_arrays(...))`
   on the genotypes of phase 5 unpacked to int8 on the card: launch
   counts 3 / 1 / 1 / 1 for kernels 9 / 10 / 12 / 11 and none of 1-8, the
   float64 gate, and per-PC agreement with the packed run of phase 5;
11. EigenSNP on the dense container (`run_eigensnp_workflow` with
   `packed_pipeline=False`, in-process) on a PLINK fileset of 65,536 SNPs
   x 10,000 samples: its stage split, launches of 10, 11 and 12 only, its
   TSVs against a float64 PCA; then `python -m genomic_pca_tpu_torch
   --project` of the same fileset through the fitted model: its scores
   against the fit's (self-projection) and against a float64 host
   `transform` of the genotypes made on the card;
12. the four dense 2-D kernels (13 `fused_right_apply_2d`, 14
   `fused_left_apply_2d`, 7i and 8i, the int8 branches of
   `right_apply_2d_q8` / `left_apply_2d_q8`) against their plain versions
   at 65,536 x 16,384 (1 GiB of int8), L = 128, and at 70,001 x 16,389
   (container width 16,512), and 13 and 14 at the thin shapes of phase 4
   and 13 at L = 10, each with a bit-identical second launch, as 5 and 6
   in phase 4;
13. the dense 2-D main path, `streamed_pca(ShardedMatrix.from_arrays(...))`
   on the genotypes of phase 6 unpacked to int8 on the card (131,072 x
   16,384, 2 GiB): launch counts 3 / 3 / 3 / 1 for 7i / 8i / 13 / 14 and
   none of any other kernel, phase 6's float64 gate, and per-PC agreement
   with the packed 2-D run;
14. the host-streamed container (ops/streaming.py): (a) `streamed_pca`
   over a packed `StreamingMatrix` of phase 5's genotypes in strips of
   2,048 rows against the resident run; (b) `run_eigensnp_workflow(...,
   force_streaming=True)` on phase 8's fileset (packed strips, 2-D mode,
   stages 1-2 through the host accessor) and (c) the same with
   `packed_pipeline=False` (dense int8 strips: kernels 13 and 14 per
   strip), each against phase 8's TSVs and its float64 oracle; each run's
   stage split, launch counts and the upload telemetry of every pass.

The CLI phases hold the separated PCs to a float64 oracle.  The line
before the last two is one JSON object with a row per kernel (its launches
on the main path, its error against its plain version, CUDA-event times
of the kernel, its plain version and the one PyTorch call that computes
the same product where there is one, and the bound: the least time of
the card for the same bytes and operations).  The line before the last
is the `nvidia-smi` name and power limit; the last line is {"ok": true,
"device": {...}}.  Needs one CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
WORK = ROOT / "build" / "chip_smoke"
FILESET = ROOT / "build" / "chip_smoke_eigensnp"  # phase 8's, kept for 14
SEED = 20260

# Kernel vs plain, both on the card, as max|kernel - plain| / max|plain|.
# q8: the same integers and the same z, only the f32 sums over tiles and
# splits run in another order.  bf16: the same rounded operands; W is
# rounded to bf16 after a sum taken in another order, so a few entries
# move by one bf16 ulp of W.  On an H100 the 1-D four stay at or below
# 1.3e-6 at both shapes; the bound is about ten times that, so a dropped
# row tile or tail (17 rows of 70,001 move the Gram by about 2.4e-4)
# fails.  right_apply_2d_q8 sums integers below 2^24 and converts once:
# it must equal its plain version bit for bit.
TOL = {
    "fused_gram_q8_packed": 1e-5,
    "fused_gram_apply_packed": 1e-5,
    "fused_tsq_packed": 1e-5,
    "fused_right_apply_packed": 1e-5,
    "fused_right_apply_2d_packed": 1e-5,
    "fused_left_apply_2d_packed": 1e-5,
    "right_apply_2d_q8": 0.0,
    "left_apply_2d_q8": 1e-5,
    "fused_gram_q8": 1e-5,
    "fused_gram_apply": 1e-5,
    "fused_tsq": 1e-5,
    "fused_right_apply": 1e-5,
    "fused_right_apply_2d": 1e-5,
    "fused_left_apply_2d": 1e-5,
    "right_apply_2d_q8_i8": 0.0,
    "left_apply_2d_q8_i8": 1e-5,
}
KERNELS_1D = ("fused_gram_q8_packed", "fused_gram_apply_packed",
              "fused_tsq_packed", "fused_right_apply_packed")
KERNELS_2D = ("fused_right_apply_2d_packed", "fused_left_apply_2d_packed",
              "right_apply_2d_q8", "left_apply_2d_q8")
KERNELS_DENSE = ("fused_gram_q8", "fused_gram_apply", "fused_tsq",
                 "fused_right_apply")
KERNELS_DENSE_2D = ("fused_right_apply_2d", "fused_left_apply_2d",
                    "right_apply_2d_q8_i8", "left_apply_2d_q8_i8")
# The wrapper of each kernel whose launch count has another name: the
# 2-D q8 products dispatch on the genotype dtype.
WRAPPER = {"right_apply_2d_q8_i8": "right_apply_2d_q8",
           "left_apply_2d_q8_i8": "left_apply_2d_q8"}
CSRC = "genomic_pca_tpu_torch/csrc/"
PK = "genomic_pca_tpu/ops/pallas_kernels.py:"
SOURCES = {
    "fused_gram_q8_packed": (CSRC + "q8_kernels.cu", PK + "977"),
    "fused_gram_apply_packed": (CSRC + "exact_kernels.cu", PK + "492"),
    "fused_tsq_packed": (CSRC + "exact_kernels.cu", PK + "564"),
    "fused_right_apply_packed": (CSRC + "exact_kernels.cu", PK + "529"),
    "fused_right_apply_2d_packed": (CSRC + "right2d_kernels.cu", PK + "675"),
    "fused_left_apply_2d_packed": (CSRC + "wide_kernels.cu", PK + "723"),
    "right_apply_2d_q8": (CSRC + "wide_kernels.cu", PK + "1096"),
    "left_apply_2d_q8": (CSRC + "wide_kernels.cu", PK + "1139"),
    "fused_gram_q8": (CSRC + "dense_kernels.cu", PK + "847"),
    "fused_gram_apply": (CSRC + "dense_kernels.cu", PK + "144"),
    "fused_tsq": (CSRC + "dense_kernels.cu", PK + "215"),
    "fused_right_apply": (CSRC + "dense_kernels.cu", PK + "181"),
    "fused_right_apply_2d": (CSRC + "right2d_kernels.cu", PK + "296"),
    "fused_left_apply_2d": (CSRC + "wide_kernels.cu", PK + "346"),
    "right_apply_2d_q8_i8": (CSRC + "wide_kernels.cu", PK + "1096"),
    "left_apply_2d_q8_i8": (CSRC + "wide_kernels.cu", PK + "1139"),
}
ZERO_LAUNCHES = dict.fromkeys(
    KERNELS_1D + KERNELS_2D + KERNELS_DENSE + KERNELS_DENSE_2D, 0)
# Kernels with a fixed sum order and no atomics: a second launch on the
# same inputs must give the same bits.  The tensor-core products, left
# and right.
LEFT_MMA = ("fused_left_apply_2d_packed", "fused_left_apply_2d")
RIGHT_MMA = ("fused_right_apply_2d_packed", "fused_right_apply_2d")
BITWISE_RERUN = LEFT_MMA + RIGHT_MMA

# The card's peaks for the bound (NVIDIA's H100 SXM data sheet, dense):
# device memory rate, and tensor-core rates for the operand type of each
# product (bf16 for the exact kernels, int8 for the q8 ones).
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {"bf16": 989e12, "int8": 1979e12}
Q8_KERNELS = ("fused_gram_q8_packed", "fused_gram_q8", "right_apply_2d_q8",
              "left_apply_2d_q8", "right_apply_2d_q8_i8", "left_apply_2d_q8_i8")
TWO_PRODUCTS = ("fused_gram_q8_packed", "fused_gram_q8", "fused_gram_apply_packed",
                "fused_gram_apply")


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# Data made on the card from a seed.


def structured_packed(torch, d, n, n_pops, fst, missing, seed, device):
    """Balding-Nichols genotypes packed to PLINK bytes on the device.

    Returns (packed (d, n/4) uint8, mean (d,), std (d,)) on the device;
    std is the sample std (ddof 1) over valid entries."""
    import numpy as np

    rng = np.random.default_rng(seed)
    anc = rng.uniform(0.1, 0.9, size=d)
    a = anc * (1 - fst) / fst
    b = (1 - anc) * (1 - fst) / fst
    pop_freqs = torch.from_numpy(
        rng.beta(a[:, None], b[:, None], size=(d, n_pops)).astype(np.float32)
    ).to(device)
    # Unequal population sizes spread the structured eigenvalues apart,
    # so that more of the top PCs are separated by an eigengap.
    w = 0.7 ** np.arange(n_pops)
    pop_of = torch.from_numpy(rng.choice(n_pops, size=n, p=w / w.sum())).to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    packed = torch.empty((d, n // 4), dtype=torch.uint8, device=device)
    counts = torch.empty((d, 3), dtype=torch.float64, device=device)
    for lo in range(0, d, 16384):
        hi = min(lo + 16384, d)
        f = pop_freqs[lo:hi][:, pop_of]
        g = ((torch.rand(f.shape, generator=gen, device=device) < f).to(torch.int32)
             + (torch.rand(f.shape, generator=gen, device=device) < f).to(torch.int32))
        miss = torch.rand(f.shape, generator=gen, device=device) < missing
        # count_A1 codes: 2 -> 00, 1 -> 10, 0 -> 11, missing -> 01
        code = torch.where(g == 2, 0, 3 - g)
        code = torch.where(miss, 1, code).reshape(hi - lo, n // 4, 4)
        packed[lo:hi] = (code[..., 0] | (code[..., 1] << 2) | (code[..., 2] << 4)
                         | (code[..., 3] << 6)).to(torch.uint8)
        valid = ~miss
        gv = torch.where(valid, g, 0).to(torch.float64)
        counts[lo:hi, 0] = valid.sum(1)
        counts[lo:hi, 1] = gv.sum(1)
        counts[lo:hi, 2] = (gv * gv).sum(1)
    nv, s1, s2 = counts[:, 0], counts[:, 1], counts[:, 2]
    mean = s1 / nv
    std = torch.sqrt(torch.clamp((s2 - nv * mean * mean) / (nv - 1), min=0.0))
    return packed, mean.to(torch.float32), std.to(torch.float32)


def dense_from_packed(torch, packed):
    """(D, N4) PLINK bytes -> (D, 4 N4) int8 dosages on the card, -127
    for missing (and for 0x55 padding)."""
    from genomic_pca_tpu_torch.ops.kernels import packed_codes

    out = torch.empty((packed.shape[0], 4 * packed.shape[1]), dtype=torch.int8,
                      device=packed.device)
    for lo in range(0, packed.shape[0], 16384):
        c = packed_codes(packed[lo:lo + 16384])
        out[lo:lo + 16384] = torch.where(c == 1, -127, (4 - c) >> 1).to(torch.int8)
    return out


def exact_pca_f64(torch, packed, mean, inv_std, k):
    """Float64 PCA of A = diag(inv_std)(G - mean), missing -> 0, on the
    card, accumulating A^T A over row chunks: (eigvecs (N, k), the top
    k + 1 eigenvalues, so that PC k's gap to the next can be read)."""
    from genomic_pca_tpu_torch.ops.kernels import packed_codes

    n = packed.shape[1] * 4
    gram = torch.zeros((n, n), dtype=torch.float64, device=packed.device)
    for lo in range(0, packed.shape[0], 16384):
        c = packed_codes(packed[lo:lo + 16384])
        x = ((4 - c) >> 1).to(torch.float64) - mean[lo:lo + 16384, None].double()
        x = torch.where(c != 1, x * inv_std[lo:lo + 16384, None].double(), 0.0)
        gram += x.T @ x
    evals, evecs = torch.linalg.eigh(gram)
    return evecs.flip(1)[:, :k], evals.flip(0)[: k + 1]


def separated_prefix(evals, k):
    """Number of leading PCs each separated from both neighbours by a
    relative eigengap of at least 5%.  `evals` holds k + 1 descending
    eigenvalues; PC j counts only if the gap to PC j + 1 is wide too, so a
    PC inside a cluster (or at the edge of the noise bulk) never counts."""
    for j in range(k):
        if (evals[j] - evals[j + 1]) / max(evals[j], 1e-300) < 0.05:
            return j
    return k


def check_pcs(np, scores, v_true, ev_true, got_ev, k, label):
    """Per-PC |r| > 0.999 and eigenvalues within 1e-3 relative over the
    separated prefix, plus principal cosines of that subspace.  Beyond the
    prefix the PCs are not determined, but every Rayleigh-Ritz value is a
    lower bound of its eigenvalue: none may exceed it by more than 1e-3."""
    sep = separated_prefix(ev_true, k)
    if sep < 1:
        raise AssertionError(f"{label}: no eigengap-separated PC to check")
    rs = []
    for j in range(sep):
        x = scores[:, j] - scores[:, j].mean()
        y = v_true[:, j] - v_true[:, j].mean()
        rs.append(abs(float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))))
    qf, _ = np.linalg.qr(scores[:, :sep].astype(np.float64))
    qe, _ = np.linalg.qr(v_true[:, :sep])
    cos = float(np.linalg.svd(qf.T @ qe, compute_uv=False).min())
    ev_rel = np.abs(got_ev[:sep] - ev_true[:sep]) / ev_true[:sep]
    ritz = (got_ev[:k] - ev_true[:k]) / ev_true[:k]
    log(f"[{label}] separated prefix {sep}/{k}; min |r| {min(rs):.7f}; "
        f"min principal cosine {cos:.7f}; max eigenvalue rel err "
        f"{float(ev_rel.max()):.3e}; eigenvalue rel err beyond the prefix "
        f"{[round(float(x), 5) for x in ritz[sep:]]}")
    if (min(rs) <= 0.999 or cos <= 0.999 or float(ev_rel.max()) > 1e-3
            or float(ritz.max()) > 1e-3):
        raise AssertionError(f"{label}: PCs disagree with the float64 oracle: "
                             f"|r| {rs}, cosine {cos}, eigenvalue rel err {ritz}")
    return sep, min(rs), float(ev_rel.max())


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions.


def median_ms(torch, fn, reps):
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def kernel_cases(torch, d, n, seed, device, names, ell=128):
    """Inputs for each kernel of `names` at one shape: {name: (args,
    kwargs)}; `ell` the columns of B of the 2-D right products (the others
    take 128, the 1-D right products 10)."""
    from genomic_pca_tpu_torch.ops.kernels import (
        fused_right_apply_2d_packed_plain, quantize_rows,
    )
    from genomic_pca_tpu_torch.ops.rsvd import quantize_basis
    from genomic_pca_tpu_torch.parallel.sharded import (
        dense_cols, inv_std_of, packed_cols,
    )

    n4 = packed_cols(n)
    n_d = dense_cols(n)  # the dense container's width
    packed_data, mean, std = structured_packed(
        torch, d, 4 * (-(-n // 4)), 4, 0.1, 0.01, seed, device)
    packed = torch.full((d, n4), 0x55, dtype=torch.uint8, device=device)
    packed[:, : packed_data.shape[1]] = packed_data
    mean = mean[:, None].contiguous()
    inv = torch.from_numpy(inv_std_of(std.cpu().numpy()).astype("float32"))
    inv = inv[:, None].to(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed + 1)

    def basis(ell):
        b = torch.randn((4 * n4, ell), generator=gen, device=device) / n ** 0.5
        b[n:] = 0.0
        return b

    b128 = basis(128)
    b_right = b128 if ell == 128 else basis(ell)
    bq, sb, csum = quantize_basis(b128)
    # z8 / sz of a 2-D q8 pass, quantized per row tile of 1,024.
    z8, sz = quantize_rows(torch.randn((d, 128), generator=gen, device=device), 1024)
    geno = (dense_from_packed(torch, packed[:, : n_d // 4])
            if set(names) & set(KERNELS_DENSE + KERNELS_DENSE_2D) else None)
    b_d = b128[:n_d]
    cases = {
        "fused_gram_q8_packed": lambda: ((packed, inv, mean * inv, bq, sb, csum),
                                         {"tile_d": 1024}),
        "fused_gram_apply_packed": lambda: ((packed, mean, inv, b128),
                                            {"precision": "bf16"}),
        "fused_tsq_packed": lambda: ((packed, mean, inv, b128), {"precision": "bf16"}),
        "fused_right_apply_packed": lambda: ((packed, mean, inv, basis(10)),
                                             {"precision": "bf16"}),
        "fused_right_apply_2d_packed": lambda: ((packed, mean, inv, b_right),
                                                {"precision": "bf16"}),
        # W as the 2-D gram pass gives it: A B in f32.
        "fused_left_apply_2d_packed": lambda: (
            (packed, mean, inv,
             fused_right_apply_2d_packed_plain(packed, mean, inv, b128)),
            {"precision": "bf16"}),
        "right_apply_2d_q8": lambda: ((packed, bq), {}),
        "left_apply_2d_q8": lambda: ((packed, z8, sz), {"tile_d": 1024}),
        "fused_gram_q8": lambda: ((geno, inv, mean * inv, *quantize_basis(b_d)),
                                  {"tile_d": 1024}),
        "fused_gram_apply": lambda: ((geno, mean, inv, b_d), {"precision": "bf16"}),
        "fused_tsq": lambda: ((geno, mean, inv, b_d), {"precision": "bf16"}),
        "fused_right_apply": lambda: ((geno, mean, inv, basis(10)[:n_d]),
                                      {"precision": "bf16"}),
        "fused_right_apply_2d": lambda: ((geno, mean, inv, b_right[:n_d]),
                                         {"precision": "bf16"}),
        "fused_left_apply_2d": lambda: (
            (geno, mean, inv, fused_right_apply_2d_packed_plain(geno, mean, inv, b_d)),
            {"precision": "bf16"}),
        "right_apply_2d_q8_i8": lambda: ((geno, quantize_basis(b_d)[0]), {}),
        "left_apply_2d_q8_i8": lambda: ((geno, z8, sz), {"tile_d": 1024}),
    }
    return {name: cases[name]() for name in names}


def bound_of(torch, name, args, out):
    """(bound ms, "bytes" or "operations"): the least time the card could
    take for a kernel's work on these inputs, the larger of its bytes
    (each input read once, each output written once) over the memory rate
    and its operations (2 D N L per product, N the padded sample count
    the kernel runs over, plus 2 D L^2 for tsq's W^T W) over the
    tensor-core peak of its operand type."""
    from genomic_pca_tpu_torch.ops import kernels as tk

    outs = out if isinstance(out, tuple) else (out,)
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs)
                 if torch.is_tensor(t))
    geno = args[0]
    d, n, ell = geno.shape[0], tk._samples(geno), outs[0].shape[-1]
    ops = (2 if name in TWO_PRODUCTS else 1) * 2 * d * n * ell
    if name in ("fused_tsq_packed", "fused_tsq"):
        ell = args[3].shape[1]
        ops = 2 * d * n * ell + 2 * d * ell * ell
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = ops / PEAK_OPS_PER_S["int8" if name in Q8_KERNELS else "bf16"]
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def library_call(torch, name, args):
    """(label, fn) of the one PyTorch call that computes a kernel's
    product on the same inputs already decoded (and standardized in bf16),
    or None where no single call does (the q8 passes and the per-tile
    scaled left q8 products).  A yardstick only: the port never calls it."""
    from genomic_pca_tpu_torch.ops import kernels as tk

    geno = args[0]
    if name in ("right_apply_2d_q8", "right_apply_2d_q8_i8"):
        g0 = tk.dosages_g0(geno).contiguous()
        bq = args[1].t().contiguous().t()  # column-major, as cuBLASLt takes it
        return "torch._int_mm(G0, bq)", lambda: torch._int_mm(g0, bq)
    if name in Q8_KERNELS:
        return None
    a = tk.standardize(geno, args[1], args[2], "bf16").to(torch.bfloat16)
    b = args[3].to(torch.bfloat16)
    if name in ("fused_left_apply_2d_packed", "fused_left_apply_2d"):
        at = a.t()
        return "torch.matmul(A^T, W)", lambda: torch.matmul(at, b)
    if name in ("fused_gram_apply_packed", "fused_gram_apply"):
        at = a.t()
        return "torch.linalg.multi_dot([A^T, A, B])", (
            lambda: torch.linalg.multi_dot([at, a, b]))
    if name in ("fused_tsq_packed", "fused_tsq"):
        at, bt = a.t(), b.t()
        return "torch.linalg.multi_dot([B^T, A^T, A, B])", (
            lambda: torch.linalg.multi_dot([bt, at, a, b]))
    return "torch.matmul(A, B)", lambda: torch.matmul(a, b)


def check_kernels(torch, d, n, seed, device, reps, names, ell=128):
    from genomic_pca_tpu_torch.ops import kernels as tk

    results = {}
    for name, (args, kw) in kernel_cases(torch, d, n, seed, device, names,
                                         ell).items():
        kern = getattr(tk, WRAPPER.get(name, name))
        plain = tk.PLAIN[name]

        def run_k():
            return kern(*args, **kw)

        def run_p():
            return plain(*args, **kw)

        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        bound_ms, bound_by = bound_of(torch, name, args, got)
        ell = (got[0] if isinstance(got, tuple) else got).shape[-1]
        if name in BITWISE_RERUN:
            if not torch.equal(got, run_k()):
                raise AssertionError(f"{name}: a second launch gave other bits")
            if name in LEFT_MMA:
                tile, grid = tk.left2d_plan(got.shape[0], ell)
                plan = (f"tile {tile} (samples x columns), grid {grid}, every "
                        "row in each block")
            else:
                tile, grid, splits = tk.right2d_plan(d, args[3].shape[0], ell)
                plan = (f"tile {tile} (rows x columns), grid {grid}, the samples "
                        f"in {splits} range(s)")
            log(f"[kernel] {name} D={d} N={n} L={ell}: {plan}; a second launch "
                "repeats bit for bit")
        if isinstance(got, tuple):  # a q8 pass: T = out - ru
            got, ref = got[0] - got[1], ref[0] - ref[1]
        if got.shape != ref.shape or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"{name}: shape {tuple(got.shape)} vs "
                                 f"{tuple(ref.shape)} or non-finite output")
        err = float((got - ref).abs().max())
        scale = float(ref.abs().max())
        del got, ref
        # Timed in turns: plain, kernel, kernel, plain.
        p1 = median_ms(torch, run_p, reps)
        k1 = median_ms(torch, run_k, reps)
        k2 = median_ms(torch, run_k, reps)
        p2 = median_ms(torch, run_p, reps)
        ms, plain_ms = min(k1, k2), min(p1, p2)
        lib = library_call(torch, name, args)
        lib_ms = None
        if lib is not None:
            lib[1]()
            lib_ms = min(median_ms(torch, lib[1], reps),
                         median_ms(torch, lib[1], reps))
        del lib
        ok = err <= TOL[name] * scale
        log(f"[kernel] {name} D={d} N={n} L={ell}: max abs err {err:.4e} "
            f"(max|plain| {scale:.4e}, rel {err / scale:.3e}, "
            f"tol {TOL[name]:.0e}) kernel {ms:.4f} ms plain {plain_ms:.4f} ms "
            f"library {'-' if lib_ms is None else f'{lib_ms:.4f}'} ms bound "
            f"{bound_ms:.4f} ms ({bound_by}) {'OK' if ok else 'FAIL'}")
        if not ok:
            raise AssertionError(f"{name} disagrees with its plain version")
        results[name] = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": lib_ms}
        torch.cuda.empty_cache()
    return results


def compare_modes(torch, np, d, n, seed, device, reps):
    """At a wide shape: the 1-D gram and q8 passes against the 2-D ones
    (kernel 5 then 6; q8_power_pass_2d), and q8_power_pass_2d against a
    float64 replay of its quantization model at its own tile."""
    from genomic_pca_tpu_torch.ops import kernels as tk

    (packed, mean, inv, b), _ = kernel_cases(
        torch, d, n, seed, device, ["fused_gram_apply_packed"]
    )["fused_gram_apply_packed"]
    from genomic_pca_tpu_torch.ops.rsvd import quantize_basis

    bq, sb, csum = quantize_basis(b)
    u = mean * inv
    tile = 1024
    passes = {
        "gram 1-D (kernel 2)": lambda: tk.fused_gram_apply_packed(packed, mean, inv, b),
        "gram 2-D (kernels 5, 6)": lambda: tk.fused_left_apply_2d_packed(
            packed, mean, inv, tk.fused_right_apply_2d_packed(packed, mean, inv, b)),
        "q8 1-D (kernel 1)": lambda: tk.fused_gram_q8_packed(
            packed, inv, u, bq, sb, csum, tile_d=tile),
        "q8 2-D (kernels 7, 8 + glue)": lambda: tk.q8_power_pass_2d(
            packed, inv, u, bq, sb, csum, tile_d=tile),
    }
    times = {}
    for label, fn in passes.items():
        fn()
        times[label] = min(median_ms(torch, fn, reps), median_ms(torch, fn, reps))
    log(f"[modes] D={d} N={n} L=128 CUDA-event medians (ms): "
        + ", ".join(f"{k} {v:.4f}" for k, v in times.items()))
    out, ru = tk.q8_power_pass_2d(packed, inv, u, bq, sb, csum, tile_d=tile)
    t = (out - ru).double()
    g0 = tk.unpack_dosages(packed)
    bqs = bq.double() * float(sb)
    ref = torch.zeros_like(t)
    ry = torch.zeros((1, t.shape[1]), dtype=torch.float64, device=device)
    for lo in range(0, d, tile):
        g = g0[lo:lo + tile].double()
        iv, uu = inv[lo:lo + tile].double(), u[lo:lo + tile].double()
        y = (iv * g - uu) @ bqs
        z = iv * y
        sz = z.abs().max() / 127.0 + 1e-30
        ref += g.T @ torch.clamp(torch.round(z / sz), -127, 127) * sz
        ry += (uu * y).sum(0, keepdim=True)
    ref -= ry
    rel = float((t - ref).abs().max() / ref.abs().max())
    log(f"[modes] q8_power_pass_2d vs float64 replay at tile {tile}: max|d| / "
        f"max|ref| {rel:.3e} (bound 1e-3: an f32-level difference in z can "
        "flip single 8-bit roundings)")
    if not rel <= 1e-3:
        raise AssertionError("q8_power_pass_2d disagrees with its quantization model")
    return times


# ---------------------------------------------------------------------------
# Phase 5: a VCF directory.


def write_vcf_dir(np, path: Path, n_samples, n_variants, n_files, n_pops,
                  seed):
    """Structured biallelic SNPs, GT only, n_pops populations (n_pops - 1
    structured PCs); returns the dosages (V, N)."""
    rng = np.random.default_rng(seed)
    fst = 0.1
    anc = rng.uniform(0.05, 0.95, size=n_variants)
    a = anc * (1 - fst) / fst
    b = (1 - anc) * (1 - fst) / fst
    pf = rng.beta(a[:, None], b[:, None], size=(n_variants, n_pops))
    w = 0.7 ** np.arange(n_pops)
    pop_of = rng.choice(n_pops, size=n_samples, p=w / w.sum())
    geno = rng.binomial(2, pf[:, pop_of]).astype(np.int8)
    tok = np.frombuffer(b"0/0\t0/1\t1/1\t", dtype=np.uint8).reshape(3, 4)
    names = "\t".join(f"HG{i:05d}" for i in range(n_samples))
    header = ("##fileformat=VCFv4.2\n"
              '##FORMAT=<ID=GT,Number=1,Type=String,Description="Genotype">\n'
              "#CHROM\tPOS\tID\tREF\tALT\tQUAL\tFILTER\tINFO\tFORMAT\t"
              + names + "\n").encode()
    per = -(-n_variants // n_files)
    for f in range(n_files):
        lo, hi = f * per, min((f + 1) * per, n_variants)
        body = tok[geno[lo:hi]].reshape(hi - lo, 4 * n_samples)
        body[:, -1] = ord("\n")
        with open(path / f"chr{f + 1:02d}.vcf", "wb") as fh:
            fh.write(header)
            for i in range(hi - lo):
                fh.write(f"{f + 1}\t{1000 + 10 * i}\t.\tA\tC\t.\tPASS\t.\tGT\t"
                         .encode())
                fh.write(body[i].tobytes())
    return geno


def check_cli(torch, np, device, n_v, n_files, n_pops, seed, k):
    """`python -m genomic_pca_tpu_torch` on a generated VCF directory of
    2,504 samples; TSV layout and PCs against a float64 oracle."""
    label = f"cli {n_v}x{n_pops}pop"
    if WORK.exists():
        shutil.rmtree(WORK)
    vcf_dir = WORK / "vcf"
    vcf_dir.mkdir(parents=True)
    n_s = 2504
    t0 = time.perf_counter()
    geno = write_vcf_dir(np, vcf_dir, n_s, n_v, n_files, n_pops, seed)
    log(f"[{label}] wrote {n_v} variants x {n_s} samples of {n_pops} "
        f"populations in {n_files} VCF files in {time.perf_counter() - t0:.1f} s")
    prefix = WORK / "out"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "genomic_pca_tpu_torch", "-d", str(vcf_dir),
         "-o", str(prefix), "-k", str(k), "--rfit-seed", "5"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if "timing]" in line or "Assembled" in line or "Total run time" in line:
            log(f"[{label}] {line.split('] ', 1)[-1]}")
    if proc.returncode != 0:
        raise AssertionError(f"CLI exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    log(f"[{label}] python -m genomic_pca_tpu_torch exit 0 in {wall:.2f} s")
    pcs = np.loadtxt(f"{prefix}.vcf.pca.tsv", skiprows=1,
                     usecols=range(1, k + 1), delimiter="\t")
    evs = np.loadtxt(f"{prefix}.eigenvalues.tsv", skiprows=1, usecols=1,
                     delimiter="\t")
    with open(f"{prefix}.vcf.pca.tsv") as fh:
        head = fh.readline().rstrip("\n").split("\t")
        first = fh.readline().split("\t", 1)[0]
    if head != ["SampleID"] + [f"PC{i}" for i in range(1, k + 1)] or first != "HG00000":
        raise AssertionError(f"unexpected TSV header/sample order: {head[:3]} {first}")
    if pcs.shape != (n_s, k) or evs.shape != (k,):
        raise AssertionError(f"TSV shapes {pcs.shape}, {evs.shape}")
    # Oracle: the workflow's MAF gate (0.01) and center-only scaling.
    freq = geno.sum(1, dtype=np.int64) / (2.0 * n_s)
    kept = geno[np.minimum(freq, 1 - freq) >= 0.01]
    x = torch.from_numpy(kept).to(device, torch.float64)
    x = x - x.mean(dim=1, keepdim=True)
    ev, vec = torch.linalg.eigh(x.T @ x)
    v_true = vec.flip(1)[:, :k].cpu().numpy()
    ev_true = ev.flip(0)[: k + 1].cpu().numpy()
    log(f"[{label}] {kept.shape[0]} variants pass the MAF gate")
    check_pcs(np, pcs, v_true, ev_true, evs * (n_s - 1), k, label)
    shutil.rmtree(WORK)


def check_main(torch, np, device, label, d, n, k, seed, dense=False,
               oracle=None):
    """The main path on structured genotypes made on the card, twice, in
    the packed layout or (`dense`) unpacked to int8 on the card; returns
    (launch counts of the first run, scores, float64 oracle, separated
    prefix).  `oracle` reuses the float64 PCA of the same genotypes."""
    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, inv_std_of

    packed, mean, std = structured_packed(torch, d, n, 11, 0.1, 0.01, seed, device)
    mean_np, std_np = mean.cpu().numpy(), std.cpu().numpy()
    if dense:
        geno_np = dense_from_packed(torch, packed).cpu().numpy()
        lows = range(0, d, 32768)

        def build():
            return ShardedMatrix.from_arrays(
                (geno_np[lo:lo + 32768] for lo in lows),
                means=[mean_np[lo:lo + 32768] for lo in lows],
                stds=[std_np[lo:lo + 32768] for lo in lows], device=device)
    else:
        packed_np = packed.cpu().numpy()

        def build():
            return ShardedMatrix.from_packed_rows(packed_np, mean_np, std_np, n,
                                                  device=device)
    runs = []
    for run in range(2):
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm = build()
        res = streamed_pca(sm, k=k, n_power_iter=4, seed=7,
                           compute_loadings=True)
        torch.cuda.synchronize()
        runs.append(time.perf_counter() - t0)
        if run == 0:
            launches = dict(tk.LAUNCHES)
    log(f"[{label}] streamed_pca {d} x {n} ({sm.mode} mode), k={k}, 4 power "
        f"iterations: wall {runs[0]:.3f} s (first run), {runs[1]:.3f} s (second "
        f"run), upload included; launches {launches}")
    if (res.scores.shape != (n, k) or res.loadings.shape != (d, k)
            or not np.isfinite(res.scores).all()
            or not np.isfinite(res.loadings).all()):
        raise AssertionError(f"{label}: output has the wrong shape or non-finite values")
    del sm
    if oracle is None:
        inv_t = torch.from_numpy(inv_std_of(std_np).astype(np.float32)).to(device)
        t0 = time.perf_counter()
        v_true, ev_true = exact_pca_f64(torch, packed, mean, inv_t, k)
        oracle = (v_true.cpu().numpy(), ev_true.cpu().numpy())
        log(f"[{label}] float64 oracle in {time.perf_counter() - t0:.1f} s")
    sep, _, _ = check_pcs(np, res.scores, *oracle,
                          res.singular_values.astype(np.float64) ** 2, k, label)
    return launches, res.scores, oracle, sep


def write_plink_fileset(np, prefix: Path, packed, n_blocks):
    """PLINK BED/BIM/FAM of count_A1 packed rows (SNP-major, made on the
    card), SNP i at chr 1 position 10 (i + 1); and a block file of
    `n_blocks` equal intervals."""
    d, n4 = packed.shape
    with open(f"{prefix}.bed", "wb") as fh:
        fh.write(b"\x6c\x1b\x01")
        fh.write(packed.cpu().numpy().tobytes())
    with open(f"{prefix}.bim", "w") as fh:
        fh.write("".join(f"1\tsnp{i}\t0\t{10 * (i + 1)}\tA\tC\n" for i in range(d)))
    with open(f"{prefix}.fam", "w") as fh:
        fh.write("".join(f"sample{i}\tsample{i}\t0\t0\t0\t-9\n" for i in range(4 * n4)))
    per = 10 * d // n_blocks
    with open(f"{prefix}.blocks.tsv", "w") as fh:
        fh.write("".join(f"1 {b * per + 1} {(b + 1) * per}\n" for b in range(n_blocks)))


def check_eigensnp_cli(torch, np, device, d, n, n_blocks, k, seed):
    """`python -m genomic_pca_tpu_torch --eigensnp` at its defaults on a
    generated PLINK fileset: 5 populations of unequal size at Fst 0.03 (so
    that most SNPs pass the default HWE filter at 16,384 samples), 0.5%
    missing.  Gate: its TSVs against a float64 PCA of the PCA SNPs its
    loadings list, with the QC moments (mean, sample std over valid
    genotypes).  The fileset stays in FILESET for phase 14; returns
    (prefix, the CLI's scores, the float64 oracle, its separated prefix)."""
    from genomic_pca_tpu_torch.parallel.sharded import inv_std_of

    label = "eigensnp cli"
    if FILESET.exists():
        shutil.rmtree(FILESET)
    FILESET.mkdir(parents=True)
    t0 = time.perf_counter()
    packed, mean, std = structured_packed(torch, d, n, 5, 0.03, 0.005, seed, device)
    prefix = FILESET / "cohort"
    write_plink_fileset(np, prefix, packed, n_blocks)
    log(f"[{label}] wrote {d} SNPs x {n} samples ({d * n // 4 / 2**20:.0f} MiB BED) "
        f"in {n_blocks} LD blocks in {time.perf_counter() - t0:.1f} s")
    out = FILESET / "out"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "genomic_pca_tpu_torch", "--eigensnp",
         "--bed-file", str(prefix), "--ld-block-file", f"{prefix}.blocks.tsv",
         "-o", str(out)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    launches = None
    for line in proc.stderr.splitlines():
        msg = line.split("] ", 1)[-1]
        if msg.startswith(("SNP QC:", "LD mapping:", "EigenSNP matrix loaded",
                           "EigenSNP stage split:", "Total run time")):
            log(f"[{label}] {msg}")
        if msg.startswith("Kernel launches: "):
            launches = json.loads(msg[len("Kernel launches: "):])
    if proc.returncode != 0:
        raise AssertionError(f"CLI exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    log(f"[{label}] python -m genomic_pca_tpu_torch --eigensnp exit 0 in "
        f"{wall:.2f} s; launches {launches}")
    want = dict(ZERO_LAUNCHES, fused_right_apply_2d_packed=3,
                fused_left_apply_2d_packed=1)
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    pcs = np.loadtxt(f"{out}.eigensnp.pca.tsv", skiprows=1,
                     usecols=range(1, k + 1), delimiter="\t")
    evs = np.loadtxt(f"{out}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    with open(f"{out}.eigensnp.loadings.tsv") as fh:
        head = fh.readline().rstrip("\n").split("\t")
        ids = [line.split("\t", 1)[0] for line in fh]
    with open(f"{out}.eigensnp.pca.tsv") as fh:
        pc_head = fh.readline().rstrip("\n").split("\t")
        first = fh.readline().split("\t", 1)[0]
    if (pc_head != ["SampleID"] + [f"PC{i}" for i in range(1, k + 1)]
            or head[:3] != ["VariantID", "Chrom", "Pos"] or first != "sample0"):
        raise AssertionError(f"unexpected TSV layout: {pc_head[:3]} {head[:4]} {first}")
    if pcs.shape != (n, k) or evs.shape != (k,) or not np.isfinite(pcs).all():
        raise AssertionError(f"TSV shapes {pcs.shape}, {evs.shape} or non-finite")
    sel = torch.as_tensor([int(v[3:]) for v in ids], device=device)
    log(f"[{label}] {len(ids)} of {d} SNPs are PCA SNPs (QC + LD mapping)")
    inv = torch.from_numpy(inv_std_of(std[sel].cpu().numpy()).astype(np.float32))
    t0 = time.perf_counter()
    v_true, ev_true = exact_pca_f64(torch, packed[sel], mean[sel], inv.to(device), k)
    log(f"[{label}] float64 oracle in {time.perf_counter() - t0:.1f} s")
    oracle = (v_true.cpu().numpy(), ev_true.cpu().numpy())
    sep, _, _ = check_pcs(np, pcs, *oracle, evs * (n - 1), k, label)
    return prefix, pcs, oracle, sep


def log_messages(label, messages, prefixes):
    for msg in messages:
        if msg.startswith(prefixes):
            log(f"[{label}] {msg}")


class Captured:
    """Messages of the port's loggers while the block runs."""

    def __enter__(self):
        import logging

        self.messages = []
        self.handler = logging.Handler()
        self.handler.emit = lambda record: self.messages.append(record.getMessage())
        self.logger = logging.getLogger("genomic_pca_tpu_torch")
        self.logger.addHandler(self.handler)
        self.logger.setLevel(logging.INFO)
        return self.messages

    def __exit__(self, *exc):
        self.logger.removeHandler(self.handler)


def check_dense_eigensnp_and_projection(torch, np, device, d, n, n_blocks, k,
                                        seed):
    """EigenSNP on the dense container, then `--project` of the same
    fileset through the fitted model.  The fit: `run_eigensnp_workflow`
    with `packed_pipeline=False` (the API is the entry point of that
    configuration; the CLI has no flag for it) at the CLI's defaults,
    launch counts, TSVs against a float64 PCA of its PCA SNPs.  The
    projection: the CLI in a subprocess; its scores against the fit's
    over the separated prefix (self-projection, tests/test_project.py)
    and against the float64 host `transform` of the genotypes made on the
    card (not read back from the BED), summed over SNP strips."""
    from genomic_pca_tpu_torch.models.pca import transform
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.parallel.sharded import inv_std_of
    from genomic_pca_tpu_torch.workflows import (
        DataPrepConfig, EigenSnpConfig, run_eigensnp_workflow,
    )

    label = "dense eigensnp"
    if WORK.exists():
        shutil.rmtree(WORK)
    WORK.mkdir(parents=True)
    t0 = time.perf_counter()
    packed, mean, std = structured_packed(torch, d, n, 5, 0.03, 0.005, seed, device)
    prefix = WORK / "cohort"
    write_plink_fileset(np, prefix, packed, n_blocks)
    log(f"[{label}] wrote {d} SNPs x {n} samples ({d * n // 4 / 1e6:.0f} MB BED) "
        f"in {n_blocks} LD blocks in {time.perf_counter() - t0:.1f} s")
    fit = WORK / "fit"
    with Captured() as messages:
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        run_eigensnp_workflow(
            DataPrepConfig(bed_path=str(prefix), ld_block_path=f"{prefix}.blocks.tsv",
                           packed_pipeline=False),
            EigenSnpConfig(), str(fit), write_moments=True, device=device)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    log_messages(label, messages, ("SNP QC:", "LD mapping:", "EigenSNP matrix loaded",
                                   "EigenSNP stage split:"))
    log(f"[{label}] run_eigensnp_workflow(packed_pipeline=False) in {wall:.2f} s; "
        f"launches {launches}")
    want = dict(ZERO_LAUNCHES, fused_gram_apply=1, fused_tsq=1, fused_right_apply=1)
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    pcs = np.loadtxt(f"{fit}.eigensnp.pca.tsv", skiprows=1,
                     usecols=range(1, k + 1), delimiter="\t")
    evs = np.loadtxt(f"{fit}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    ids = np.loadtxt(f"{fit}.eigensnp.loadings.tsv", skiprows=1, usecols=0,
                     dtype=str, delimiter="\t").tolist()
    loadings = np.loadtxt(f"{fit}.eigensnp.loadings.tsv", skiprows=1,
                          usecols=range(3, 3 + k), delimiter="\t")
    m_ids = np.loadtxt(f"{fit}.eigensnp.moments.tsv", skiprows=1, usecols=0,
                       dtype=str, delimiter="\t").tolist()
    m_mean, m_std = np.loadtxt(f"{fit}.eigensnp.moments.tsv", skiprows=1,
                               usecols=(3, 4), delimiter="\t", unpack=True)
    if (pcs.shape != (n, k) or evs.shape != (k,) or m_ids != ids
            or loadings.shape != (len(ids), k) or not np.isfinite(pcs).all()):
        raise AssertionError(f"TSV shapes {pcs.shape}, {evs.shape}, "
                             f"{loadings.shape} or non-finite")
    rows = np.asarray([int(v[3:]) for v in ids])
    sel = torch.as_tensor(rows, device=device)
    log(f"[{label}] {len(ids)} of {d} SNPs are PCA SNPs (QC + LD mapping)")
    inv = torch.from_numpy(inv_std_of(std[sel].cpu().numpy()).astype(np.float32))
    t0 = time.perf_counter()
    v_true, ev_true = exact_pca_f64(torch, packed[sel], mean[sel], inv.to(device), k)
    log(f"[{label}] float64 oracle in {time.perf_counter() - t0:.1f} s")
    sep, _, _ = check_pcs(np, pcs, v_true.cpu().numpy(), ev_true.cpu().numpy(),
                          evs * (n - 1), k, label)
    del v_true

    label = "project cli"
    proj = WORK / "proj"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "genomic_pca_tpu_torch", "--project",
         "--bed-file", str(prefix), "--project-loadings",
         f"{fit}.eigensnp.loadings.tsv", "--project-moments",
         f"{fit}.eigensnp.moments.tsv", "-o", str(proj)],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=900,
    )
    wall = time.perf_counter() - t0
    for line in proc.stderr.splitlines():
        if "timing]" in line or "Total run time" in line:
            log(f"[{label}] {line.split('] ', 1)[-1]}")
    if proc.returncode != 0:
        raise AssertionError(f"CLI exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    log(f"[{label}] python -m genomic_pca_tpu_torch --project exit 0 in {wall:.2f} s")
    scores = np.loadtxt(f"{proj}.projected.pca.tsv", skiprows=1,
                        usecols=range(1, k + 1), delimiter="\t")
    if scores.shape != (n, k) or not np.isfinite(scores).all():
        raise AssertionError(f"projected scores {scores.shape} or non-finite")
    rs = []
    for j in range(sep):
        x, y = scores[:, j] - scores[:, j].mean(), pcs[:, j] - pcs[:, j].mean()
        rs.append(abs(float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y)))))
    t0 = time.perf_counter()
    host = np.zeros((n, k))
    for lo in range(0, len(rows), 8192):
        hi = min(lo + 8192, len(rows))
        g = dense_from_packed(torch, packed[sel[lo:hi]]).cpu().numpy()
        host += transform(g, loadings[lo:hi], m_mean[lo:hi], m_std[lo:hi])
    rel = float(np.abs(scores - host).max() / np.abs(host).max())
    log(f"[{label}] self-projection per-PC |r| over the separated prefix "
        f"{[round(r, 7) for r in rs]}; max|scores - float64 transform| / "
        f"max|transform| {rel:.3e} (bound 1e-4; transform in "
        f"{time.perf_counter() - t0:.1f} s)")
    if min(rs) <= 0.999 or not rel <= 1e-4:
        raise AssertionError(f"{label}: projection disagrees: |r| {rs}, rel {rel}")
    shutil.rmtree(WORK)


def check_streamed_main(torch, np, device, d, n, k, seed, strip, resident):
    """Phase 14a: `streamed_pca` over a packed StreamingMatrix of the
    genotypes of the resident 1-D run (the same seed makes the same
    genotypes), strips of `strip` rows held on the host; launch counts,
    upload telemetry, the float64 gate and per-PC agreement with the
    resident run.  `resident` is (scores, oracle, separated prefix)."""
    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix

    label = "streamed main 1-D"
    packed, mean, std = structured_packed(torch, d, n, 11, 0.1, 0.01, seed, device)
    packed_np, mean_np, std_np = (x.cpu().numpy() for x in (packed, mean, std))
    del packed, mean, std

    def source(i):
        lo, hi = i * strip, min((i + 1) * strip, d)
        return packed_np[lo:hi], mean_np[lo:hi], std_np[lo:hi]

    n_strips = -(-d // strip)
    with Captured() as messages:
        sm = StreamingMatrix(source, n_strips, d, n, strip, packed=True, device=device)
        tk.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = streamed_pca(sm, k=k, n_power_iter=4, seed=7, compute_loadings=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    log_messages(label, messages, ("Host-streamed container", "Streamed pass"))
    log(f"[{label}] streamed_pca {d} x {n} ({sm.mode} mode, {n_strips} strips of "
        f"{strip} rows), k={k}: wall {wall:.3f} s; launches {launches}")
    want = dict(ZERO_LAUNCHES, fused_gram_q8_packed=3 * n_strips,
                fused_gram_apply_packed=n_strips, fused_right_apply_packed=n_strips)
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    if (res.scores.shape != (n, k) or res.loadings.shape != (d, k)
            or not np.isfinite(res.scores).all()):
        raise AssertionError(f"{label}: output has the wrong shape or non-finite values")
    scores, oracle, sep = resident
    check_pcs(np, res.scores, *oracle, res.singular_values.astype(np.float64) ** 2,
              k, label)
    rs = [abs(float(np.corrcoef(res.scores[:, j], scores[:, j])[0, 1]))
          for j in range(sep)]
    log(f"[{label}] per-PC |r| against the resident run over the separated "
        f"prefix: min {min(rs):.7f}")
    if min(rs) <= 0.999:
        raise AssertionError(f"{label}: streamed and resident runs disagree: {rs}")
    return launches


def check_streamed_eigensnp(torch, np, device, fileset, k, packed_pipeline):
    """Phase 14b/c: `run_eigensnp_workflow(force_streaming=True)` on phase
    8's fileset, in-process: the host-streamed container (packed strips,
    or dense int8 strips with `packed_pipeline=False`) in 2-D mode, stages
    1-2 through the host accessor; stage split, launches (the right and
    left 2-D kernels of the layout, per strip: one gram pass and one
    tsq_and_project pass), upload telemetry of every pass, and its TSVs
    against phase 8's TSVs and float64 oracle."""
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.workflows import (
        DataPrepConfig, EigenSnpConfig, run_eigensnp_workflow,
    )

    prefix, ref_pcs, oracle, sep = fileset
    label = f"streamed eigensnp {'packed' if packed_pipeline else 'dense'}"
    out = FILESET / ("streamed_packed" if packed_pipeline else "streamed_dense")
    cfg = EigenSnpConfig()
    with Captured() as messages:
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        run_eigensnp_workflow(
            DataPrepConfig(bed_path=str(prefix), ld_block_path=f"{prefix}.blocks.tsv",
                           packed_pipeline=packed_pipeline),
            cfg, str(out), device=device, force_streaming=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(tk.LAUNCHES)
    log_messages(label, messages, ("Host-streamed container", "EigenSNP matrix",
                                   "EigenSNP stage split:", "Streamed pass"))
    pcs = np.loadtxt(f"{out}.eigensnp.pca.tsv", skiprows=1, usecols=range(1, k + 1),
                     delimiter="\t")
    evs = np.loadtxt(f"{out}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    n_snps = sum(1 for _ in open(f"{out}.eigensnp.loadings.tsv")) - 1
    strips = -(-n_snps // cfg.snp_strip_size)
    log(f"[{label}] run_eigensnp_workflow(force_streaming=True) in {wall:.2f} s; "
        f"{n_snps} PCA SNPs in {strips} strips; launches {launches}")
    right, left = (("fused_right_apply_2d_packed", "fused_left_apply_2d_packed")
                   if packed_pipeline else
                   ("fused_right_apply_2d", "fused_left_apply_2d"))
    want = dict(ZERO_LAUNCHES, **{right: 2 * strips, left: strips})
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    n = ref_pcs.shape[0]
    if pcs.shape != ref_pcs.shape or not np.isfinite(pcs).all():
        raise AssertionError(f"{label}: scores {pcs.shape} or non-finite")
    check_pcs(np, pcs, *oracle, evs * (n - 1), k, label)
    rs = [abs(float(np.corrcoef(pcs[:, j], ref_pcs[:, j])[0, 1])) for j in range(sep)]
    log(f"[{label}] per-PC |r| against the resident CLI run over the separated "
        f"prefix: min {min(rs):.7f}")
    if min(rs) <= 0.999:
        raise AssertionError(f"{label}: streamed and resident runs disagree: {rs}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import numpy as np

    from genomic_pca_tpu_torch.ops import build

    device = torch.device("cuda")
    smi = smi_line()
    t_start = time.perf_counter()

    # 1. Toolchain.
    log(f"[toolchain] nvidia-smi: {smi}")
    log(f"[toolchain] python {sys.version.split()[0]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} device {torch.cuda.get_device_name(0)} "
        f"x{torch.cuda.device_count()}")
    nvcc = build.nvcc_path()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[-1]
    log(f"[toolchain] nvcc {nvcc}: {ver}")
    try:
        import triton

        log(f"[toolchain] triton {triton.__version__} imports")
    except ImportError as exc:
        log(f"[toolchain] triton does not import: {exc}")

    # 2. Build.
    lib_path, secs, nvcc_log = build.build(force=True)
    log(f"[build] {lib_path.relative_to(ROOT)} in {secs:.2f} s")
    for line in nvcc_log.splitlines():
        if "registers" in line or "spill" in line:
            log(f"[build] {line.strip()}")

    # 3. The 1-D kernels against plain versions.
    results = check_kernels(torch, 262_144, 2048, SEED, device, 5, KERNELS_1D)
    check_kernels(torch, 70_001, 2504, SEED + 1, device, 3, KERNELS_1D)

    # 4. The 2-D kernels at the wide shape and a ragged one; both modes.
    results.update(check_kernels(torch, 65_536, 16_384, SEED + 6, device, 5,
                                 KERNELS_2D))
    check_kernels(torch, 70_001, 16_389, SEED + 7, device, 3, KERNELS_2D)
    # The thinnest grids of kernels 5 and 6: a streamed strip at the
    # switch width, an EigenSNP strip (5's samples split), and the
    # loadings launch of kernel 5 (L = k = 10).
    check_kernels(torch, 2_048, 11_264, SEED + 10, device, 5,
                  ("fused_right_apply_2d_packed", "fused_left_apply_2d_packed"))
    check_kernels(torch, 2_000, 16_384, SEED + 11, device, 5,
                  ("fused_right_apply_2d_packed",))
    check_kernels(torch, 65_536, 16_384, SEED + 6, device, 3,
                  ("fused_right_apply_2d_packed",), ell=10)
    compare_modes(torch, np, 65_536, 16_384, SEED + 6, device, 5)
    torch.cuda.empty_cache()

    # 5-6. The main path in each mode.
    launches = {}
    main = {}
    for label, d, n, seed, want in (
        ("main 1-D", 262_144, 2048, SEED + 2,
         {"fused_gram_q8_packed": 3, "fused_gram_apply_packed": 1,
          "fused_tsq_packed": 1, "fused_right_apply_packed": 1}),
        ("main 2-D", 131_072, 16_384, SEED + 4,
         {"fused_right_apply_2d_packed": 3, "fused_left_apply_2d_packed": 1,
          "right_apply_2d_q8": 3, "left_apply_2d_q8": 3}),
    ):
        got, scores, oracle, sep = check_main(torch, np, device, label, d, n, 10,
                                              seed)
        if got != dict(ZERO_LAUNCHES, **want):
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        launches.update({name: got[name] for name in want})
        main[label] = (scores, oracle, sep)
        torch.cuda.empty_cache()

    # 7. The VCF CLI on VCF directories of 1000 Genomes phase 3 width:
    # 32,768 variants of 5 populations (4 structured PCs; PCs 5-10 lie in
    # the noise bulk, where only the Ritz lower bound is checked), and
    # 65,536 variants of 11 populations (10 structured PCs).
    check_cli(torch, np, device, 32_768, 8, 5, SEED + 3, 10)
    check_cli(torch, np, device, 65_536, 16, 11, SEED + 3, 10)

    # 8. The EigenSNP CLI at 16,384 samples; its fileset stays for 14.
    fileset = check_eigensnp_cli(torch, np, device, 65_536, 16_384, 64, 10,
                                 SEED + 5)

    # 9. The dense int8 kernels at the 1-D main shape, a ragged one, and
    # the exact three at the width of the dense EigenSNP run (10,000
    # samples, container width 10,112), whose tile grid and split-K
    # differ from the narrower shapes.
    results.update(check_kernels(torch, 262_144, 2048, SEED, device, 5,
                                 KERNELS_DENSE))
    check_kernels(torch, 70_001, 2504, SEED + 1, device, 3, KERNELS_DENSE)
    check_kernels(torch, 65_536, 10_000, SEED + 9, device, 3,
                  ("fused_gram_apply", "fused_tsq", "fused_right_apply"))
    torch.cuda.empty_cache()

    # 10. The dense main path on the genotypes of the packed one.
    packed_scores, oracle, sep = main["main 1-D"]
    got, scores, _, _ = check_main(torch, np, device, "main dense 1-D", 262_144,
                                   2048, 10, SEED + 2, dense=True, oracle=oracle)
    want = {"fused_gram_q8": 3, "fused_gram_apply": 1, "fused_tsq": 1,
            "fused_right_apply": 1}
    if got != dict(ZERO_LAUNCHES, **want):
        raise AssertionError(f"main dense 1-D: launch counts {got} != {want}")
    launches.update(want)
    rs = [abs(float(np.corrcoef(scores[:, j], packed_scores[:, j])[0, 1]))
          for j in range(sep)]
    log(f"[main dense 1-D] per-PC |r| against the packed run over the "
        f"separated prefix: min {min(rs):.7f}")
    if min(rs) <= 0.999:
        raise AssertionError(f"dense and packed main paths disagree: {rs}")
    torch.cuda.empty_cache()

    # 11. EigenSNP on the dense container at 10,000 samples, then --project.
    check_dense_eigensnp_and_projection(torch, np, device, 65_536, 10_000, 64, 10,
                                        SEED + 8)

    # 12. The dense 2-D kernels at the 2-D kernel shape and a ragged one.
    results.update(check_kernels(torch, 65_536, 16_384, SEED + 6, device, 5,
                                 KERNELS_DENSE_2D))
    check_kernels(torch, 70_001, 16_389, SEED + 7, device, 3, KERNELS_DENSE_2D)
    check_kernels(torch, 2_048, 11_264, SEED + 10, device, 5,
                  ("fused_right_apply_2d", "fused_left_apply_2d"))
    check_kernels(torch, 2_000, 16_384, SEED + 11, device, 5, ("fused_right_apply_2d",))
    check_kernels(torch, 65_536, 16_384, SEED + 6, device, 3,
                  ("fused_right_apply_2d",), ell=10)
    torch.cuda.empty_cache()

    # 13. The dense 2-D main path on the genotypes of the packed 2-D one.
    packed_scores, oracle, sep = main["main 2-D"]
    got, scores, _, _ = check_main(torch, np, device, "main dense 2-D", 131_072,
                                   16_384, 10, SEED + 4, dense=True, oracle=oracle)
    want = {"right_apply_2d_q8_i8": 3, "left_apply_2d_q8_i8": 3,
            "fused_right_apply_2d": 3, "fused_left_apply_2d": 1}
    if got != dict(ZERO_LAUNCHES, **want):
        raise AssertionError(f"main dense 2-D: launch counts {got} != {want}")
    launches.update(want)
    rs = [abs(float(np.corrcoef(scores[:, j], packed_scores[:, j])[0, 1]))
          for j in range(sep)]
    log(f"[main dense 2-D] per-PC |r| against the packed 2-D run over the "
        f"separated prefix: min {min(rs):.7f}")
    if min(rs) <= 0.999:
        raise AssertionError(f"dense and packed 2-D main paths disagree: {rs}")
    del scores, packed_scores
    torch.cuda.empty_cache()

    # 14. The host-streamed container: the 1-D main path in strips of
    # 2,048 rows, then EigenSNP on phase 8's fileset with packed and
    # dense strips.
    check_streamed_main(torch, np, device, 262_144, 2048, 10, SEED + 2, 2048,
                        main["main 1-D"])
    check_streamed_eigensnp(torch, np, device, fileset, 10, packed_pipeline=True)
    check_streamed_eigensnp(torch, np, device, fileset, 10, packed_pipeline=False)
    shutil.rmtree(FILESET)

    kernels_line = {"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": m["max_abs_err"], "ms": m["ms"],
         "plain_ms": m["plain_ms"], "bound_ms": m["bound_ms"],
         "bound_by": m["bound_by"], "library_ms": m["library_ms"]}
        for name, m in results.items()
    ]}
    missing = [name for name in ZERO_LAUNCHES if not launches.get(name)]
    if missing or len(results) != len(ZERO_LAUNCHES):
        raise AssertionError(f"kernels without main-path launches or timings: "
                             f"{missing}, {sorted(set(ZERO_LAUNCHES) - set(results))}")
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    print(json.dumps(kernels_line))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

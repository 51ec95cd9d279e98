"""Smoke run of the PyTorch + CUDA port on one GPU: `python3 chip_smoke.py`.

Phases (each raises on failure; the script then exits non-zero and prints
no result line):

1. toolchain: the card's name and power limit, CUDA, nvcc, triton;
2. build the hand-written kernels from genomic_pca_tpu_torch/csrc/;
3. the four 1-D kernels against their plain PyTorch versions on the
   card, at the 1-D main path's shapes (262,144 SNPs x 2,048 samples,
   L = 128; L = k = 10 for the loadings product) and at a ragged shape
   (70,001 x 2,504), with CUDA-event median times of kernel and plain
   version; the gram pass (kernel 2, on the tensor cores in bf16 mode)
   also at 2,048 x 2,048 (a streamed 1-D strip, whose plans split both
   products), each time with its plans and a bit-identical second launch;
   the gram and tsq passes (kernels 2 and 3) held half by half; the right
   product (kernel 4: the narrow kernel at L <= 16, else the 2-D right
   product's f32 store, which must equal kernel 5 bit for bit) also on
   that strip at L = 10 and L = 128; the q8 pass (kernel 1: one C call of
   7's s8 product, the requantization and 8's) at all three shapes, its
   `out` bit for bit the plain pass at its plan's row ranges, T = out - ru
   to TOL, with its plan and a bit-identical second launch;
4. the four 2-D (wide-sample) kernels the same way at 65,536 x 16,384,
   L = 128, and at 70,001 x 16,389; kernels 5-8 at 2,048 x 11,264 (a
   streamed strip at the 2-D switch width: their thinnest grids; 8's rows
   split), 5, 7 and 8 at 2,000 x 16,384 (an EigenSNP strip, whose samples
   split), 8 at row tiles of 64 on both strips and at 262,144 x 2,048
   (the 1-D width), and 5 at 65,536 x 16,384 with L = 10 (the loadings
   launch), each tensor-core product with its tile, grid (and split) and
   a bit-identical second launch, 7 and 8 bit for bit to their plain
   versions (8 at its plan's row ranges); the 1-D gram and q8 passes
   against the 2-D ones at the wide shape; `q8_power_pass_2d` against a
   float64 replay of its quantization model, and (`check_q8_pass_2d`, the
   q8 pass's one C call) bit for bit against 7, the torch requantization
   and 8 composed, at 65,536 x 16,384 and 2,048 x 11,264;
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
   on the card, with `--write-moments`; its stage split and launch counts
   (5 and 6 ran), and its TSVs against a float64 PCA of the PCA-SNP set it
   kept;
9. the four dense int8 kernels (9-12) against their plain versions at
   262,144 x 2,048 (L = 128; 10 for the right product) and at 70,001 x
   2,504 (container width 2,560), the exact three (10-12) at 65,536 x
   10,000 (container width 10,112), the width of phase 11, and the gram
   pass (kernel 10), the right product (kernel 11, L = 10 and 128) and the
   q8 pass (kernel 9) at 2,048 x 2,048, as kernels 2, 4 and 1 in phase 3;
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
   (container width 16,512), and 13, 14, 7i and 8i at the thin shapes of
   phase 4 (8i also at row tiles of 64 and at 262,144 x 2,048) and 13 at
   L = 10, each with a bit-identical second launch, as 5-8 in phase 4; the
   dense 2-D q8 pass against 7i and 8i composed, as in phase 4;
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
   stage split, launch counts and the upload telemetry of every pass;
15. several ranks, one device each in a `torch.distributed` process group
   (parallel/mesh.py): (a) a group of one rank over NCCL through phase 5's
   1-D main path (`from_local_rows`, every pass merged by an all-reduce):
   outputs bit for bit phase 5's, launch counts 3 / 1 / 1 / 1, and the
   NCCL all-reduce time of one pass; (b) two ranks spawned on the one card
   (gloo, the merges staged through pinned host memory) through the 1-D
   main path at 262,144 x 2,048 (131,072 rows a rank) and the 2-D main
   path at 131,072 x 16,384: on each rank the launch counts of the one-rank
   run (3 / 1 / 1 / 1 for kernels 1-4; 3 / 3 / 3 / 1 for 7 / 8 / 5 / 6),
   identical scores on both ranks, the float64 gate, per-PC |r| > 0.999
   and principal cosines over the separated prefix against phases 5 / 6,
   the wall and the all-reduce time of one pass; (c) `python -m
   torch.distributed.run --nproc-per-node 2 -m genomic_pca_tpu_torch -d`
   on phase 7's 65,536-variant directory (per-rank file sharding) and (d)
   the same with `--eigensnp --write-moments` on phase 8's fileset
   (distributed QC, each rank's range one unit, stages 1-2 per rank): its
   moments TSV (the QC keep-mask and moments) byte for byte phase 8's,
   rank 0's launch counts those of the one-rank run, and the TSVs against
   phases 7 / 8's and their float64 oracles; (d) takes the host scan
   (`--eigensnp-qc-mode host`) and re-reads the BED, the route that phase
   17c's capture is held to.  Two ranks on one card check correctness and
   the collective paths, not scaling;
16. the device QC scan (models/prepare.py): (a) the EigenSNP CLI with
   `--eigensnp-qc-mode device --write-moments` on phase 8's fileset: its
   moments TSV byte for byte phase 8's, the matrix assembled from the
   scan's captured batches, the launches of phase 8 and the float64
   gate; (b) in process, the packed container gathered from the capture
   against the one re-read from the BED after the host scan, bit for bit
   (geno, mean, inv_std, rows); (c) the same for the dense route
   (`packed_pipeline=False`, "auto": the device scan and an int8 capture)
   on phase 11's fileset, the route phase 11 itself took (launches of 10,
   11 and 12 only); (d) the walls of both scans and both assemblies;
17. the host-streamed container over two ranks on the one card (gloo):
   (a) `streamed_pca` over phase 5's genotypes in 2,048-row strips, 64
   strips a rank: each rank launches kernels 1, 2 and 4 for its own
   strips, the two ranks' counts add up to phase 14a's, identical scores
   on both ranks, the float64 gate and per-PC |r| > 0.999 against phase
   14a, each pass's wall and all-reduce time; (b)
   `run_eigensnp_workflow(..., force_streaming=True)` on phase 8's fileset
   at two ranks: the summed launches of phase 14b, the moments TSV byte
   for byte phase 8's, the float64 gate; (c) the two-rank EigenSNP CLI
   under `torch.distributed.run` with `--eigensnp-qc-mode device` (each
   rank's unit gathered from its own capture): moments byte for byte
   phase 15d's, rank 0's launches those of one rank, the float64 gate;
18. `--profile-dir` (inside phase 7, on its 32,768-variant directory):
   the VCF CLI again with the profiler: its TSVs byte for byte the
   untraced run's, the trace file parses as JSON and its CUDA kernel
   events name `q8_right2d_mma_kernel`, `q8_left2d_mma_kernel` and
   `right_narrow_mma_kernel`; the wall with and without the profiler;
19. the oracles and the eval chain: (a) the 1000G-like cohort of
   eval_artifacts/README.md through `eval/make_1000g_like.py` (60,000 SNPs
   x 2,504 samples, 120 LD blocks, seed 2025); (b) `python -m
   genomic_pca_tpu_torch.eval.exact` on it on the card, and in process
   `exact_pca_from_strips` on the card and on the CPU over the same
   strips: the card's eigenvalues within 1e-9 of the CPU's and per-PC |r|
   >= 1 - 1e-9 over the separated prefix, the CLI's TSVs (%.6g) the same
   to 6 significant digits; (c) `StripedMatrix` (plain f32 torch
   products) at 65,536 x 2,048: the resident container's f32 passes in
   both layouts against it to 1e-5 of max|oracle|, then `streamed_pca`
   over it (the plain power loop) through the float64 gate; (d) five
   sweep runs (`eval/sweep_run.py`: the base defaults, min_maf 0.03,
   components_per_block 18, local_power_iter 5, refine_passes 4) of the
   EigenSNP CLI on the cohort, each exit 0 with the reference's TSVs, the
   base run through the float64 gate against `exact_pca_from_strips(...,
   scale=True, apply_qc=False)` over its PCA SNPs;
20. the bench (temp files under build/chip_smoke_bench): (a) `python -m
   genomic_pca_tpu_torch.bench`: its JSON line with no `*_error` key,
   `value_method` "trace_device_time", device ms an iteration above kernel
   1's raw launch time, the traced loops' launches (63 q8 passes and one
   exact polish of kernels 1 / 2 packed and 9 / 10 dense, 64 of 10 in
   bf16), the compact biobank run (98,304 x 49,152, three CLI legs) in the
   2-D container launching 2-D kernels only, and its subset oracle's min
   per-PC |r| over the separated prefix above 0.97; (b) `python -m
   genomic_pca_tpu_torch.eval.biobank_bench` at the full-scale width
   (102,400 samples) and 32,768 SNPs: the three legs in the 2-D container,
   the residual certificate on the device backend and then on the host
   one, their per-PC residuals within 1e-4 of each other, and the subset
   oracle.

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
FILESET = ROOT / "build" / "chip_smoke_eigensnp"  # phase 8's, kept for 14-17
VCF_KEPT = ROOT / "build" / "chip_smoke_vcf"  # phase 7's second, kept for 15
DENSE_KEPT = ROOT / "build" / "chip_smoke_dense"  # phase 11's, kept for 16
G1K = ROOT / "build" / "chip_smoke_g1k"  # phase 19's cohort and runs
SEED = 20260

# Kernel vs plain, both on the card, as max|kernel - plain| / max|plain|.
# q8 passes: T = out - ru, whose `out` must also equal the plain pass at
# the plan's row ranges bit for bit; only ru sums in another order.
# bf16: the same rounded operands; W is
# rounded to bf16 after a sum taken in another order, so a few entries
# move by one bf16 ulp of W.  On an H100 the 1-D four stay at or below
# 1.3e-6 at both shapes; the bound is about ten times that, so a dropped
# row tile or tail (17 rows of 70,001 move the Gram by about 2.4e-4)
# fails.  right_apply_2d_q8 sums integers exactly in int32 (a split's
# slab too) and converts once, as its plain version: it must equal it bit
# for bit.  left_apply_2d_q8 folds each row tile's exact int32 sum into f32
# in tile order, each range of its plan apart and the ranges' slab added
# in order, as its plain version does at the plan's ranges: bit for bit
# too.  The gram passes are also
# held half by half (`check_gram`): their W against the plain right
# product, and the pass against the plain left product of that W rounded
# to bf16; the tsq passes likewise (`check_tsq`), their W^T W half against
# a float64 W^T W of that W.
TOL = {
    "fused_gram_q8_packed": 1e-5,
    "fused_gram_apply_packed": 1e-5,
    "fused_tsq_packed": 1e-5,
    "fused_right_apply_packed": 1e-5,
    "fused_right_apply_2d_packed": 1e-5,
    "fused_left_apply_2d_packed": 1e-5,
    "right_apply_2d_q8": 0.0,
    "left_apply_2d_q8": 0.0,
    "fused_gram_q8": 1e-5,
    "fused_gram_apply": 1e-5,
    "fused_tsq": 1e-5,
    "fused_right_apply": 1e-5,
    "fused_right_apply_2d": 1e-5,
    "fused_left_apply_2d": 1e-5,
    "right_apply_2d_q8_i8": 0.0,
    "left_apply_2d_q8_i8": 0.0,
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
    "fused_gram_q8_packed": (CSRC + "q8_pass.cuh", PK + "977"),
    "fused_gram_apply_packed": (CSRC + "exact_kernels.cu", PK + "492"),
    "fused_tsq_packed": (CSRC + "exact_kernels.cu", PK + "564"),
    "fused_right_apply_packed": (CSRC + "right1d_kernels.cu", PK + "529"),
    "fused_right_apply_2d_packed": (CSRC + "right2d_kernels.cu", PK + "675"),
    "fused_left_apply_2d_packed": (CSRC + "wide_kernels.cu", PK + "723"),
    "right_apply_2d_q8": (CSRC + "q8_right2d_kernels.cu", PK + "1096"),
    "left_apply_2d_q8": (CSRC + "q8_left2d_kernels.cu", PK + "1139"),
    "fused_gram_q8": (CSRC + "q8_pass.cuh", PK + "847"),
    "fused_gram_apply": (CSRC + "dense_kernels.cu", PK + "144"),
    "fused_tsq": (CSRC + "dense_kernels.cu", PK + "215"),
    "fused_right_apply": (CSRC + "right1d_kernels.cu", PK + "181"),
    "fused_right_apply_2d": (CSRC + "right2d_kernels.cu", PK + "296"),
    "fused_left_apply_2d": (CSRC + "wide_kernels.cu", PK + "346"),
    "right_apply_2d_q8_i8": (CSRC + "q8_right2d_kernels.cu", PK + "1096"),
    "left_apply_2d_q8_i8": (CSRC + "q8_left2d_kernels.cu", PK + "1139"),
}
ZERO_LAUNCHES = dict.fromkeys(
    KERNELS_1D + KERNELS_2D + KERNELS_DENSE + KERNELS_DENSE_2D, 0)
# Kernels with a fixed sum order and no atomics: a second launch on the
# same inputs must give the same bits.  The tensor-core products, left
# and right, exact and q8.
LEFT_MMA = ("fused_left_apply_2d_packed", "fused_left_apply_2d")
RIGHT_MMA = ("fused_right_apply_2d_packed", "fused_right_apply_2d")
GRAM_MMA = ("fused_gram_apply_packed", "fused_gram_apply")  # bf16 mode
Q8_RIGHT_MMA = ("right_apply_2d_q8", "right_apply_2d_q8_i8")
Q8_LEFT_MMA = ("left_apply_2d_q8", "left_apply_2d_q8_i8")
# The q8 passes: one C call of 7, the requantization and 8 (csrc/q8_pass.cuh).
Q8_PASS = ("fused_gram_q8_packed", "fused_gram_q8")
TSQ_MMA = ("fused_tsq_packed", "fused_tsq")  # bf16 mode
# bf16 mode: the narrow kernel (L <= 16), else the 2-D right product's store.
RIGHT1D_MMA = ("fused_right_apply_packed", "fused_right_apply")
BITWISE_RERUN = (LEFT_MMA + RIGHT_MMA + GRAM_MMA + Q8_RIGHT_MMA + TSQ_MMA + RIGHT1D_MMA
                 + Q8_LEFT_MMA + Q8_PASS)

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


def kernel_cases(torch, d, n, seed, device, names, ell=128, right1d_ell=10,
                 q8_tile=1024):
    """Inputs for each kernel of `names` at one shape: {name: (args,
    kwargs)}; `ell` the columns of B of the 2-D right products,
    `right1d_ell` those of the 1-D ones (the others take 128); `q8_tile`
    the row tile of the 2-D q8 left products' z8."""
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
    # z8 / sz of a 2-D q8 pass, quantized per row tile of q8_tile.
    z8, sz = quantize_rows(torch.randn((d, 128), generator=gen, device=device), q8_tile)
    geno = (dense_from_packed(torch, packed[:, : n_d // 4])
            if set(names) & set(KERNELS_DENSE + KERNELS_DENSE_2D) else None)
    b_d = b128[:n_d]
    cases = {
        "fused_gram_q8_packed": lambda: ((packed, inv, mean * inv, bq, sb, csum),
                                         {"tile_d": 1024}),
        "fused_gram_apply_packed": lambda: ((packed, mean, inv, b128),
                                            {"precision": "bf16"}),
        "fused_tsq_packed": lambda: ((packed, mean, inv, b128), {"precision": "bf16"}),
        "fused_right_apply_packed": lambda: ((packed, mean, inv, basis(right1d_ell)),
                                             {"precision": "bf16"}),
        "fused_right_apply_2d_packed": lambda: ((packed, mean, inv, b_right),
                                                {"precision": "bf16"}),
        # W as the 2-D gram pass gives it: A B in f32.
        "fused_left_apply_2d_packed": lambda: (
            (packed, mean, inv,
             fused_right_apply_2d_packed_plain(packed, mean, inv, b128)),
            {"precision": "bf16"}),
        "right_apply_2d_q8": lambda: ((packed, bq), {}),
        "left_apply_2d_q8": lambda: ((packed, z8, sz), {"tile_d": q8_tile}),
        "fused_gram_q8": lambda: ((geno, inv, mean * inv, *quantize_basis(b_d)),
                                  {"tile_d": 1024}),
        "fused_gram_apply": lambda: ((geno, mean, inv, b_d), {"precision": "bf16"}),
        "fused_tsq": lambda: ((geno, mean, inv, b_d), {"precision": "bf16"}),
        "fused_right_apply": lambda: ((geno, mean, inv, basis(right1d_ell)[:n_d]),
                                      {"precision": "bf16"}),
        "fused_right_apply_2d": lambda: ((geno, mean, inv, b_right[:n_d]),
                                         {"precision": "bf16"}),
        "fused_left_apply_2d": lambda: (
            (geno, mean, inv, fused_right_apply_2d_packed_plain(geno, mean, inv, b_d)),
            {"precision": "bf16"}),
        "right_apply_2d_q8_i8": lambda: ((geno, quantize_basis(b_d)[0]), {}),
        "left_apply_2d_q8_i8": lambda: ((geno, z8, sz), {"tile_d": q8_tile}),
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
    or None where no single call does (the q8 passes: two integer
    products with a requantization between).  A yardstick only: the port
    never calls it."""
    from genomic_pca_tpu_torch.ops import kernels as tk

    geno = args[0]
    if name in ("right_apply_2d_q8", "right_apply_2d_q8_i8"):
        g0 = tk.dosages_g0(geno).contiguous()
        bq = args[1].t().contiguous().t()  # column-major, as cuBLASLt takes it
        return "torch._int_mm(G0, bq)", lambda: torch._int_mm(g0, bq)
    if name in Q8_LEFT_MMA:
        # sum_t sz[t] G0_t^T z8_t = G0^T Z, Z = z8 with each row scaled by
        # its tile's sz: one f32 product (TF32 off), equal up to rounding.
        torch.backends.cuda.matmul.allow_tf32 = False
        z8, sz = args[1], args[2]
        g0t = tk.dosages_g0(geno).to(torch.float32).t()
        z = z8.to(torch.float32) * sz.repeat_interleave(
            -(-z8.shape[0] // sz.shape[0]))[: z8.shape[0], None]
        return "torch.matmul(G0^T, Z)", lambda: torch.matmul(g0t, z)
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


def check_gram(torch, name, args, got, ref, ties_allowed):
    """The bf16 gram pass (kernel 2 or 10) half by half: its right half's
    f32 W (kernel 5 / 13 on the same inputs: the same kernel, plan and
    sum order, so the pass's bf16 W is this W rounded once) against the
    plain right product, and the pass against the plain left product of
    that W rounded to bf16, each to TOL.  Both gates hold at every shape.
    W is rounded to bf16 after an f32 sum in another order than the plain
    version's, so an entry of W at a rounding tie lands one bf16 ulp from
    the plain W's, and moves a column of the Gram by |A| ulp(W).  At the
    shapes of the main path that is far below TOL of max|plain|; on a
    strip of 2,048 rows the Gram is ~100x smaller while a tie moves it as
    much, so there (`ties_allowed`) the pass is held to the plain gram
    within TOL of max|plain| plus, entry by entry, |A|^T |dW| over the
    tied entries dW.  Returns (ties, largest allowance) for the log."""
    from genomic_pca_tpu_torch.eval.mma2d_ab import gram_reference
    from genomic_pca_tpu_torch.ops import kernels as tk

    w_ref, w_err, ties = gram_reference(*args)
    err = float((got - w_ref).abs().max()) / float(w_ref.abs().max())
    n_ties = int(torch.count_nonzero(ties))
    log(f"[kernel] {name} halves: W vs the plain right product {w_err:.3e}, the "
        f"pass vs the plain left product of bf16(W) {err:.3e} (of max|ref|, tol "
        f"{TOL['fused_gram_apply']:.0e}); {n_ties} of {ties.numel()} W entries "
        "round one bf16 ulp from the plain W's")
    if not max(w_err, err) <= TOL["fused_gram_apply"]:
        raise AssertionError(f"{name}: a half disagrees with its plain version")
    del w_ref
    if not ties_allowed:
        return n_ties, 0.0
    allow = tk.standardize(*args[:3]).abs().T @ ties.abs()
    over = (got - ref).abs() - TOL["fused_gram_apply"] * float(ref.abs().max()) - allow
    log(f"[kernel] {name} ties: largest |A|^T|dW| {float(allow.max()):.4e}; "
        f"largest excess over TOL + allowance {float(over.max()):.4e}")
    if bool((over > 0).any()):
        raise AssertionError(f"{name}: disagrees with its plain version past its "
                             "W ties")
    return n_ties, float(allow.max())


def check_tsq(torch, name, args, got):
    """The bf16 tsq pass (kernel 3 or 12) half by half, as `check_gram`
    holds the gram pass: its right half's f32 W (kernel 5 / 13 on the same
    inputs: the same kernel, plan and sum order) against the plain right
    product, and its W^T W half against a float64 W^T W of that W rounded
    to bf16, each to TOL."""
    from genomic_pca_tpu_torch.eval.mma2d_ab import tsq_reference

    ref, w_err, ties, _ = tsq_reference(*args)
    err = float((got.double() - ref).abs().max()) / float(ref.abs().max())
    log(f"[kernel] {name} halves: W vs the plain right product {w_err:.3e}, W^T W "
        f"vs float64 over bf16(W) {err:.3e} (of max|ref|, tol "
        f"{TOL['fused_tsq']:.0e}); {int(torch.count_nonzero(ties))} of "
        f"{ties.numel()} W entries round one bf16 ulp from the plain W's")
    if not max(w_err, err) <= TOL["fused_tsq"]:
        raise AssertionError(f"{name}: a half disagrees with its reference")


def check_kernels(torch, d, n, seed, device, reps, names, ell=128,
                  ties_allowed=False, right1d_ell=10, q8_tile=1024):
    """Each kernel of `names` against its plain version at D x N (see TOL;
    `ties_allowed`: the gram passes' W ties, see `check_gram`; the q8 left
    products' plain version at their plan's row ranges), its plans and a
    second launch's bits where it has them, and CUDA-event times of
    kernel, plain version and library call.  A 1-D right product wider
    than the narrow kernel must equal the 2-D one (its route) bit for bit."""
    from genomic_pca_tpu_torch.ops import kernels as tk

    results = {}
    for name, (args, kw) in kernel_cases(torch, d, n, seed, device, names,
                                         ell, right1d_ell, q8_tile).items():
        kern = getattr(tk, WRAPPER.get(name, name))
        plain = tk.PLAIN[name]
        plain_kw = kw
        if name in Q8_LEFT_MMA:
            q8_plan = tk.q8_left2d_plan(d, tk._samples(tk.aligned_rows(args[0])),
                                        args[1].shape[1], q8_tile)
            plain_kw = dict(kw, ranges=q8_plan[2])
        if name in Q8_PASS:
            q8_plan = tk.q8_pass_plan(d, tk._samples(tk.aligned_rows(args[0])),
                                      args[3].shape[1], kw["tile_d"])
            plain_kw = dict(kw, ranges=q8_plan[1][2])

        def run_k():
            return kern(*args, **kw)

        def run_p():
            return plain(*args, **plain_kw)

        got, ref = run_k(), run_p()
        torch.cuda.synchronize()
        bound_ms, bound_by = bound_of(torch, name, args, got)
        ell = (got[0] if isinstance(got, tuple) else got).shape[-1]
        if name in BITWISE_RERUN:
            again = run_k()
            if not all(map(torch.equal, got if isinstance(got, tuple) else (got,),
                           again if isinstance(again, tuple) else (again,))):
                raise AssertionError(f"{name}: a second launch gave other bits")
            del again
            if name in LEFT_MMA:
                tile, grid, ranges = tk.left2d_plan(d, got.shape[0], ell)
                plan = (f"tile {tile} (samples x columns), grid {grid}, the rows "
                        f"in {ranges} range(s)")
            elif name in GRAM_MMA:
                geno = tk.aligned_rows(args[0])
                (rt, rg, rs), (lt, lg, lr), work = tk.gram_plan(
                    d, tk._samples(geno) // 4, args[3].shape[0], ell)
                plan = (f"right tile {rt} (rows x columns), tiles {rg} ("
                        + ("a persistent grid of at most one block an SM" if rs == 1
                           else "a block each") + f"), the samples "
                        f"in {rs} range(s); left tile {lt} (samples x columns), "
                        f"grid {lg}, the rows in {lr} range(s); workspace "
                        f"{work / 2**20:.2f} MiB")
            elif name in TSQ_MMA:
                geno = tk.aligned_rows(args[0])
                (rt, rg, rs), (wt, wg, wr), work = tk.tsq_plan(
                    d, tk._samples(geno) // 4, args[3].shape[0], ell)
                plan = (f"right tile {rt} (rows x columns), tiles {rg} ("
                        + ("a persistent grid of at most one block an SM" if rs == 1
                           else "a block each") + f"), the samples "
                        f"in {rs} range(s); W^T W tile {wt}, grid {wg}, the rows in "
                        f"{wr} range(s); workspace {work / 2**20:.2f} MiB")
            elif name in RIGHT1D_MMA and tk.right1d_route(ell, "bf16") == "narrow":
                tile, blocks, splits, chunk, work = tk.right_narrow_plan(
                    d, tk._samples(tk.aligned_rows(args[0])), ell, args[0].dtype)
                plan = (f"narrow kernel: tile {tile} (rows x columns), {blocks} "
                        f"blocks, the samples in {splits} range(s) of chunks of "
                        f"{chunk}; workspace {work / 2**20:.2f} MiB")
            elif name in RIGHT1D_MMA:
                wide = getattr(tk, RIGHT_MMA[RIGHT1D_MMA.index(name)])
                if not torch.equal(got, wide(*args, **kw)):
                    raise AssertionError(f"{name}: the wide route differs from "
                                         "the 2-D right product's bits")
                tile, grid, splits = tk.right2d_plan(d, args[3].shape[0], ell)
                plan = (f"wide route (the 2-D right product's bits): tile {tile}, "
                        f"grid {grid}, the samples in {splits} range(s)")
            elif name in Q8_LEFT_MMA:
                tile, grid, ranges, work = q8_plan
                plan = (f"tile {tile} (samples x columns), grid {grid}, row tiles of "
                        f"{q8_tile}, the rows in {len(ranges)} range(s) from tiles "
                        f"{list(ranges)}; workspace {work / 2**20:.2f} MiB")
            elif name in Q8_PASS:
                (rt, rg, rs), (lt, lg, lr), work = q8_plan
                if not torch.equal(got[0], ref[0]):
                    raise AssertionError(f"{name}: out differs from the plain pass at "
                                         "the plan's row ranges")
                plan = (f"right tile {rt} (rows x columns), grid {rg}, the samples in "
                        f"{rs} range(s); left tile {lt} (samples x columns), grid {lg}, "
                        f"the rows in {len(lr)} range(s) from tiles {list(lr)}; "
                        f"workspace {work / 2**20:.2f} MiB; out bit for bit the plain "
                        "pass at those ranges")
            elif name in Q8_RIGHT_MMA:
                tile, grid, splits = tk.q8_right2d_plan(
                    d, tk._samples(tk.aligned_rows(args[0])), ell)
                plan = (f"tile {tile} (rows x columns), grid {grid}, the samples "
                        f"in {splits} range(s) (int32 slabs)")
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
        if name in GRAM_MMA:
            check_gram(torch, name, args, got, ref, ties_allowed)
        if name in TSQ_MMA:
            check_tsq(torch, name, args, got)
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
        # With `ties_allowed` check_gram gated the gram pass against plain.
        ok = err <= TOL[name] * scale or (ties_allowed and name in GRAM_MMA)
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
        "q8 2-D (kernels 7, 8)": lambda: tk.q8_power_pass_2d(
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


def check_q8_pass_2d(torch, d, n, seed, device, dense=False):
    """`q8_power_pass_2d` (the q8 pass's one C call, csrc/q8_pass.cuh)
    against the composition of the 2-D q8 products' own wrappers with the
    requantization in torch between them (kernel 7 / 7i, `q8_requant_plain`,
    kernel 8 / 8i): `out` bit for bit, ru within 1e-5 of sum |u y| (its sum
    order is the card's own), one launch counted for each product."""
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.ops.rsvd import quantize_basis

    name = "fused_right_apply_2d" if dense else "fused_right_apply_2d_packed"
    (geno, mean, inv, b), _ = kernel_cases(torch, d, n, seed, device, [name])[name]
    bq, sb, csum = quantize_basis(b)
    u = mean * inv
    tk.reset_launch_counts()
    out, ru = tk.q8_power_pass_2d(geno, inv, u, bq, sb, csum, tile_d=1024)
    launches = {k: v for k, v in tk.LAUNCHES.items() if v}
    w = tk.right_apply_2d_q8(geno, bq)
    z8, sz, ru_c = tk.q8_requant_plain(w, inv, u, sb, csum, 1024)
    out_c = tk.left_apply_2d_q8(geno, z8, sz, 1024)
    y = inv * (w * sb) - u * csum
    allow = 1e-5 * (u * y).abs().sum(0, keepdim=True)
    torch.cuda.synchronize()
    want = dict.fromkeys(tk._Q8_2D_NAME[geno.dtype], 1)
    same, ru_err = bool(torch.equal(out, out_c)), float(((ru - ru_c).abs() / allow).max())
    log(f"[q8 pass 2-D] {'dense' if dense else 'packed'} D={d} N={n}: out bit for bit "
        f"the composition of 7, the torch requantization and 8: {same}; ru within "
        f"{ru_err:.3f} of its allowance; launches {launches}")
    if not same or ru_err > 1 or launches != want:
        raise AssertionError("q8_power_pass_2d differs from the composition of its "
                             "products")


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


def run_cli(args, timeout=900):
    """`python -m genomic_pca_tpu_torch <args>`: (the process, wall)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "genomic_pca_tpu_torch", *args],
                          cwd=ROOT, env=env, capture_output=True, text=True,
                          timeout=timeout)
    return proc, time.perf_counter() - t0


# The __global__ kernels the 1-D main path launches at 2,504 samples: the
# q8 pass's two tensor-core products and the loadings' narrow product.
TRACED_KERNELS = ("q8_right2d_mma_kernel", "q8_left2d_mma_kernel",
                  "right_narrow_mma_kernel")


def check_profile(vcf_dir, prefix, k, wall):
    """Phase 18: the VCF CLI again with `--profile-dir`: the same TSVs byte
    for byte, one trace that parses as JSON and whose CUDA kernel events
    name the hand-written kernels of the 1-D main path; the wall with and
    without the profiler."""
    label = "profile-dir"
    prof_dir = prefix.parent / "prof"
    traced = prefix.parent / "traced"
    proc, wall_p = run_cli(["-d", str(vcf_dir), "-o", str(traced), "-k", str(k),
                            "--rfit-seed", "5", "--profile-dir", str(prof_dir)])
    if proc.returncode != 0:
        raise AssertionError(f"{label}: CLI exit {proc.returncode}:\n"
                             f"{proc.stderr[-4000:]}")
    same = all(Path(f"{traced}.{ext}").read_bytes() == Path(f"{prefix}.{ext}").read_bytes()
               for ext in ("vcf.pca.tsv", "eigenvalues.tsv"))
    path = prof_dir / "trace.rank0.json"
    size = path.stat().st_size
    events = json.loads(path.read_text())["traceEvents"]
    kernels = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            kernels[ev["name"]] = kernels.get(ev["name"], 0) + 1
    found = {name: sum(c for key, c in kernels.items() if name in key)
             for name in TRACED_KERNELS}
    log(f"[{label}] VCF CLI with --profile-dir exit 0 in {wall_p:.2f} s (without: "
        f"{wall:.2f} s); trace {path.name} {size / 2**20:.1f} MiB, {len(events)} "
        f"events, {len(kernels)} distinct CUDA kernels; hand-written kernels "
        f"traced {found}; TSVs byte for byte the untraced run's: {same}")
    if not same or not all(found.values()):
        raise AssertionError(f"{label}: outputs differ ({same}) or kernels missing "
                             f"from the trace: {found}")


def check_cli(torch, np, device, n_v, n_files, n_pops, seed, k, keep=False,
              profile=False):
    """`python -m genomic_pca_tpu_torch` on a generated VCF directory of
    2,504 samples; TSV layout and PCs against a float64 oracle.  With
    `keep` the directory stays for phase 15, which gets (directory, the
    CLI's scores, the float64 oracle); with `profile` phase 18 runs on
    it (`check_profile`)."""
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
    proc, wall = run_cli(["-d", str(vcf_dir), "-o", str(prefix), "-k", str(k),
                          "--rfit-seed", "5"])
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
    if profile:
        check_profile(vcf_dir, prefix, k, wall)
    if keep:
        shutil.rmtree(VCF_KEPT, ignore_errors=True)
        shutil.move(str(WORK), str(VCF_KEPT))
        return VCF_KEPT / "vcf", pcs, (v_true, ev_true)
    shutil.rmtree(WORK)
    return None


def check_main(torch, np, device, label, d, n, k, seed, dense=False,
               oracle=None):
    """The main path on structured genotypes made on the card, twice, in
    the packed layout or (`dense`) unpacked to int8 on the card; returns
    (launch counts of the first run, its PcaResult, float64 oracle,
    separated prefix).  `oracle` reuses the float64 PCA of the same
    genotypes."""
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
    return launches, res, oracle, sep


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
         "-o", str(out), "--write-moments"],
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
    log_messages(label, messages, ("SNP QC:", "LD mapping:", "QC->matrix capture",
                                   "Matrix assembly", "EigenSNP matrix loaded",
                                   "EigenSNP stage split:"))
    log(f"[{label}] run_eigensnp_workflow(packed_pipeline=False) in {wall:.2f} s; "
        f"launches {launches}")
    if not any(m.startswith("Matrix assembly from the QC scan") for m in messages):
        raise AssertionError(f"{label}: 'auto' did not take the device scan and "
                             "its int8 capture")
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
    shutil.rmtree(DENSE_KEPT, ignore_errors=True)
    shutil.move(str(WORK), str(DENSE_KEPT))
    return DENSE_KEPT / "cohort"


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
    return launches, res.scores


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


# ---------------------------------------------------------------------------
# Phase 15: several ranks.


def time_all_reduce(torch, rows, cols, device, reps=10):
    """Median host-clock ms of one `mesh.all_reduce_sum` of a (rows, cols)
    f32 tensor on the card (the merge of one pass), the ranks aligned by a
    barrier before each call."""
    from genomic_pca_tpu_torch.parallel import mesh

    t = torch.randn((rows, cols), device=device)
    times = []
    for _ in range(reps + 2):
        mesh.barrier()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mesh.all_reduce_sum(t)
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    times = sorted(times[2:])
    return times[len(times) // 2]


def rank_main_path(spec):
    """Phase 15b, on each rank of the process group: the genotypes of
    phase 5 or 6 made on this rank's card from the same seed, this rank's
    tile-aligned rows through `ShardedMatrix.from_local_rows`, then
    `streamed_pca`; returns the launches and collectives of the run, its
    wall, the all-reduce time of one pass and the outputs."""
    import numpy as np
    import torch

    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.parallel import mesh
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix

    dev = mesh.rank_device("cuda")
    d, n = spec["d"], spec["n"]
    rank, world = mesh.process_index(), mesh.process_count()
    packed, mean, std = structured_packed(torch, d, n, 11, 0.1, 0.01, spec["seed"], dev)
    per = -(-(-(-d // world)) // 1024) * 1024
    lo, hi = rank * per, min(d, (rank + 1) * per)
    rows = tuple(x[lo:hi].cpu().numpy() for x in (packed, mean, std))
    del packed, mean, std
    torch.cuda.empty_cache()

    def read_rows(a, b):
        if (a, b) != (lo, hi):
            raise AssertionError(f"rank {rank} asked for rows [{a}, {b}), not "
                                 f"[{lo}, {hi})")
        return rows

    mesh.barrier()
    tk.reset_launch_counts()
    mesh.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sm = ShardedMatrix.from_local_rows(read_rows, d, n, dev, packed=True)
    res = streamed_pca(sm, k=spec["k"], n_power_iter=4, seed=7, compute_loadings=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches, collectives = dict(tk.LAUNCHES), dict(mesh.COLLECTIVES)
    return {"rank": rank, "rows": (lo, hi), "mode": sm.mode, "wall": wall,
            "launches": launches, "collectives": collectives,
            "all_reduce_ms": time_all_reduce(torch, sm.n_pad, 128, dev),
            "scores": res.scores, "sigma": res.singular_values,
            "loadings_ok": bool(res.loadings.shape == (d, spec["k"])
                                and np.isfinite(res.loadings).all())}


def per_pc_agreement(np, a, b, sep):
    """(min per-PC |r|, min principal cosine) of the first `sep` PCs."""
    rs = [abs(float(np.corrcoef(a[:, j], b[:, j])[0, 1])) for j in range(sep)]
    qa = np.linalg.qr(a[:, :sep].astype(np.float64))[0]
    qb = np.linalg.qr(b[:, :sep].astype(np.float64))[0]
    return min(rs), float(np.linalg.svd(qa.T @ qb, compute_uv=False).min())


def kernel_launches(messages):
    """The kernel launch counts a workflow logged at its end."""
    return next(json.loads(m[len("Kernel launches: "):]) for m in messages
                if m.startswith("Kernel launches: "))


def torchrun(args, label, timeout=900):
    """`python -m torch.distributed.run --standalone --nproc-per-node 2
    -m genomic_pca_tpu_torch <args>`: (rank 0's log messages, wall)."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    env["OMP_NUM_THREADS"] = "4"
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "genomic_pca_tpu_torch", *args],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout,
    )
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: torch.distributed.run exit "
                             f"{proc.returncode}:\n{proc.stderr[-6000:]}")
    return [line.split("] ", 1)[-1] for line in proc.stderr.splitlines()], wall


def check_multirank(torch, np, device, main, main_res, vcf_run, fileset):
    """Phase 15 (module docstring)."""
    from genomic_pca_tpu_torch.eval.multichip import run_ranks
    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.parallel import mesh
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix

    # (a) A process group of one rank over NCCL: phase 5's run, bit for bit.
    label = "ranks 1 nccl"
    pg = ROOT / "build" / "chip_smoke_pg"
    shutil.rmtree(pg, ignore_errors=True)
    pg.mkdir(parents=True)
    d, n = 262_144, 2048
    mesh.initialize_distributed("cuda", init_method=f"file://{pg}/store", rank=0,
                                world_size=1, backend="nccl")
    try:
        packed, mean, std = structured_packed(torch, d, n, 11, 0.1, 0.01, SEED + 2,
                                              device)
        rows = tuple(x.cpu().numpy() for x in (packed, mean, std))
        del packed, mean, std
        tk.reset_launch_counts()
        mesh.reset_collective_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sm = ShardedMatrix.from_local_rows(lambda a, b: rows, d, n, device, packed=True)
        res = streamed_pca(sm, k=10, n_power_iter=4, seed=7, compute_loadings=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches, collectives = dict(tk.LAUNCHES), dict(mesh.COLLECTIVES)
        ar_ms = time_all_reduce(torch, sm.n_pad, 128, device)
        ref = main_res["main 1-D"]
        same = {key: bool(np.array_equal(getattr(res, key), getattr(ref, key)))
                for key in ("scores", "singular_values", "eigenvalues", "loadings")}
        log(f"[{label}] {torch.distributed.get_backend()} world 1: streamed_pca {d} x {n} wall "
            f"{wall:.3f} s; launches {launches}; collectives {collectives}; "
            f"all-reduce of ({sm.n_pad}, 128) f32 {ar_ms:.3f} ms (median of 10); "
            f"bit for bit phase 5: {same}")
        want = dict(ZERO_LAUNCHES, fused_gram_q8_packed=3, fused_gram_apply_packed=1,
                    fused_tsq_packed=1, fused_right_apply_packed=1)
        if launches != want or not all(same.values()):
            raise AssertionError(f"{label}: launches {launches} or outputs differ "
                                 f"from phase 5: {same}")
    finally:
        mesh.shutdown()
        shutil.rmtree(pg, ignore_errors=True)
    del sm, rows
    torch.cuda.empty_cache()

    # (b) Two ranks on the one card over gloo, each rank's rows from
    # from_local_rows: the 1-D and 2-D main paths of phases 5 and 6.
    for label, d, n, seed, want in (
        ("ranks 2 main 1-D", 262_144, 2048, SEED + 2,
         {"fused_gram_q8_packed": 3, "fused_gram_apply_packed": 1,
          "fused_tsq_packed": 1, "fused_right_apply_packed": 1}),
        ("ranks 2 main 2-D", 131_072, 16_384, SEED + 4,
         {"fused_right_apply_2d_packed": 3, "fused_left_apply_2d_packed": 1,
          "right_apply_2d_q8": 3, "left_apply_2d_q8": 3}),
    ):
        t0 = time.perf_counter()
        outs = run_ranks(rank_main_path, 2, ({"d": d, "n": n, "seed": seed, "k": 10},),
                         device="cuda", timeout_s=600)
        spawn_wall = time.perf_counter() - t0
        ref_scores, oracle, sep = main[label.replace("ranks 2 ", "")]
        for out in outs:
            log(f"[{label}] rank {out['rank']}: rows [{out['rows'][0]}, "
                f"{out['rows'][1]}) ({out['mode']} mode); streamed_pca wall "
                f"{out['wall']:.3f} s; launches {out['launches']}; collectives "
                f"{out['collectives']}; all-reduce of one pass (gloo, staged "
                f"through pinned host memory) {out['all_reduce_ms']:.3f} ms "
                f"(median of 10)")
            if out["launches"] != dict(ZERO_LAUNCHES, **want):
                raise AssertionError(f"{label}: rank {out['rank']} launches "
                                     f"{out['launches']} != the one-rank {want}")
            if not out["loadings_ok"] or not np.array_equal(out["scores"],
                                                            outs[0]["scores"]):
                raise AssertionError(f"{label}: ranks disagree or bad loadings")
        log(f"[{label}] two spawned ranks in {spawn_wall:.1f} s (start-up, data "
            "and both runs)")
        check_pcs(np, outs[0]["scores"], *oracle,
                  outs[0]["sigma"].astype(np.float64) ** 2, 10, label)
        r_min, cos = per_pc_agreement(np, outs[0]["scores"], ref_scores, sep)
        log(f"[{label}] against the one-rank run over the separated prefix: min "
            f"|r| {r_min:.7f}, min principal cosine {cos:.7f}")
        if r_min <= 0.999 or cos <= 0.999:
            raise AssertionError(f"{label}: two ranks and one rank disagree")
        torch.cuda.empty_cache()

    # (c) The VCF CLI on two ranks, on phase 7's second directory.
    label = "ranks 2 vcf cli"
    vcf_dir, ref_pcs, (v_true, ev_true) = vcf_run
    prefix = VCF_KEPT / "ranks2"
    msgs, wall = torchrun(["-d", str(vcf_dir), "-o", str(prefix), "-k", "10",
                           "--rfit-seed", "5"], label)
    log_messages(label, msgs, ("Process group:", "Assembled", "Total run time"))
    launches = kernel_launches(msgs)
    log(f"[{label}] torch.distributed.run --nproc-per-node 2 exit 0 in "
        f"{wall:.2f} s; rank 0 launches {launches}")
    want = dict(ZERO_LAUNCHES, fused_gram_q8_packed=3, fused_gram_apply_packed=1,
                fused_tsq_packed=1, fused_right_apply_packed=1)
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    pcs = np.loadtxt(f"{prefix}.vcf.pca.tsv", skiprows=1, usecols=range(1, 11),
                     delimiter="\t")
    evs = np.loadtxt(f"{prefix}.eigenvalues.tsv", skiprows=1, usecols=1,
                     delimiter="\t")
    sep, _, _ = check_pcs(np, pcs, v_true, ev_true, evs * (pcs.shape[0] - 1), 10,
                          label)
    r_min, cos = per_pc_agreement(np, pcs, ref_pcs, sep)
    log(f"[{label}] against phase 7's one-rank CLI: min |r| {r_min:.7f}, min "
        f"principal cosine {cos:.7f}")
    if r_min <= 0.999 or cos <= 0.999:
        raise AssertionError(f"{label}: two ranks and one rank disagree")

    # (d) The EigenSNP CLI on two ranks, on phase 8's fileset: distributed
    # QC, each rank's range as one unit, stages 1-2 per rank.
    label = "ranks 2 eigensnp cli"
    bed, ref_pcs, oracle, _sep = fileset
    out = FILESET / "ranks2"
    msgs, wall = torchrun(["--eigensnp", "--bed-file", str(bed), "--ld-block-file",
                           f"{bed}.blocks.tsv", "-o", str(out), "--write-moments",
                           "--eigensnp-qc-mode", "host"], label)
    log_messages(label, msgs, ("Process group:", "Distributed SNP QC", "SNP QC:",
                               "LD mapping:", "EigenSNP matrix loaded",
                               "EigenSNP stage split:", "Total run time"))
    launches = kernel_launches(msgs)
    log(f"[{label}] torch.distributed.run --nproc-per-node 2 exit 0 in "
        f"{wall:.2f} s; rank 0 launches {launches}")
    want = dict(ZERO_LAUNCHES, fused_right_apply_2d_packed=3,
                fused_left_apply_2d_packed=1)
    if launches != want:
        raise AssertionError(f"{label}: launch counts {launches} != {want}")
    one_rank = FILESET / "out.eigensnp.moments.tsv"
    same_qc = (Path(f"{out}.eigensnp.moments.tsv").read_bytes()
               == one_rank.read_bytes())
    n_kept = sum(1 for _ in open(one_rank)) - 1
    log(f"[{label}] QC keep-mask and moments ({n_kept} PCA SNPs) bit for bit "
        f"phase 8's: {same_qc}")
    if not same_qc:
        raise AssertionError(f"{label}: the distributed QC differs from phase 8's")
    pcs = np.loadtxt(f"{out}.eigensnp.pca.tsv", skiprows=1, usecols=range(1, 11),
                     delimiter="\t")
    evs = np.loadtxt(f"{out}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    sep, _, _ = check_pcs(np, pcs, *oracle, evs * (pcs.shape[0] - 1), 10, label)
    r_min, cos = per_pc_agreement(np, pcs, ref_pcs, sep)
    log(f"[{label}] against phase 8's one-rank CLI: min |r| {r_min:.7f}, min "
        f"principal cosine {cos:.7f}")
    if r_min <= 0.999 or cos <= 0.999:
        raise AssertionError(f"{label}: two ranks and one rank disagree")


# ---------------------------------------------------------------------------
# Phase 16: the device QC scan and its capture.


def check_device_scan(torch, np, device, fileset, dense_prefix):
    """Phase 16 (module docstring)."""
    from genomic_pca_tpu_torch.config import DataPrepConfig
    from genomic_pca_tpu_torch.models.prepare import prepare_data

    # (a) The EigenSNP CLI with the device scan on phase 8's fileset.
    label = "device scan cli"
    prefix, ref_pcs, oracle, _sep = fileset
    out = FILESET / "device_scan"
    proc, wall = run_cli(["--eigensnp", "--bed-file", str(prefix), "--ld-block-file",
                          f"{prefix}.blocks.tsv", "-o", str(out), "--write-moments",
                          "--eigensnp-qc-mode", "device"])
    if proc.returncode != 0:
        raise AssertionError(f"{label}: CLI exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    msgs = [line.split("] ", 1)[-1] for line in proc.stderr.splitlines()]
    log_messages(label, msgs, ("SNP QC", "QC->matrix capture", "Matrix assembly",
                               "Memory preflight", "EigenSNP matrix loaded",
                               "EigenSNP stage split:", "Total run time"))
    launches = kernel_launches(msgs)
    same = (Path(f"{out}.eigensnp.moments.tsv").read_bytes()
            == (FILESET / "out.eigensnp.moments.tsv").read_bytes())
    log(f"[{label}] --eigensnp-qc-mode device exit 0 in {wall:.2f} s; launches "
        f"{launches}; moments TSV byte for byte phase 8's: {same}")
    want = dict(ZERO_LAUNCHES, fused_right_apply_2d_packed=3,
                fused_left_apply_2d_packed=1)
    if launches != want or not same:
        raise AssertionError(f"{label}: launches {launches} or moments differ")
    if not any(m.startswith("Matrix assembly from the QC scan") for m in msgs):
        raise AssertionError(f"{label}: the matrix was not assembled from the capture")
    pcs = np.loadtxt(f"{out}.eigensnp.pca.tsv", skiprows=1, usecols=range(1, 11),
                     delimiter="\t")
    evs = np.loadtxt(f"{out}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    sep, _, _ = check_pcs(np, pcs, *oracle, evs * (pcs.shape[0] - 1), 10, label)
    r_min, cos = per_pc_agreement(np, pcs, ref_pcs, sep)
    log(f"[{label}] against phase 8's host-scan CLI: min |r| {r_min:.7f}, min "
        f"principal cosine {cos:.7f}")
    if r_min <= 0.999 or cos <= 0.999:
        raise AssertionError(f"{label}: device scan and host scan runs disagree")

    # (b), (c), (d): in process, the captured container against the re-read
    # one, packed on phase 8's fileset and dense ("auto") on phase 11's.
    for label, bed, packed_pipeline, scan in (
            ("capture packed", prefix, True, "device"),
            ("capture dense", dense_prefix, False, "auto")):
        got = {}
        for mode in (scan, "host"):
            cfg = DataPrepConfig(bed_path=str(bed), ld_block_path=f"{bed}.blocks.tsv",
                                 qc_mode=mode, packed_pipeline=packed_pipeline)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep = prepare_data(cfg, device=device)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            captured = prep.qc_capture is not None
            sm = prep.load_matrix(device)
            torch.cuda.synchronize()
            got[mode] = (sm, captured, t1 - t0, time.perf_counter() - t1)
        (sm_c, captured, scan_s, load_s), (sm_r, captured_r, host_s, reread_s) = (
            got[scan], got["host"])
        same = {key: bool(torch.equal(getattr(sm_c, key), getattr(sm_r, key)))
                for key in ("geno", "mean", "inv_std")}
        same["n_rows"] = sm_c.n_rows == sm_r.n_rows
        log(f"[{label}] {sm_c.n_rows} PCA SNPs, geno {tuple(sm_c.geno.shape)} "
            f"{sm_c.geno.dtype}: qc_mode={scan} device scan {scan_s:.3f} s + "
            f"assembly from the capture {load_s:.3f} s; host scan {host_s:.3f} s "
            f"+ BED re-read and upload {reread_s:.3f} s; captured {captured} / "
            f"{captured_r}; bit for bit {same}")
        if not captured or captured_r or not all(same.values()):
            raise AssertionError(f"{label}: the capture container differs from "
                                 f"the re-read one: {same}")
        del got, sm_c, sm_r
        torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# Phase 17: the host-streamed container over two ranks.


def rank_streamed_path(spec):
    """Phase 17a on each rank: phase 5's genotypes made on this rank's card
    from the same seed, a host-streamed container of 2,048-row strips
    (strip i on rank i mod 2), then `streamed_pca`; returns the launches
    and collectives of the run, its wall, each pass's wall and merge time
    and the outputs."""
    import numpy as np
    import torch

    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix
    from genomic_pca_tpu_torch.parallel import mesh

    dev = mesh.rank_device("cuda")
    d, n, strip = spec["d"], spec["n"], spec["strip"]
    packed, mean, std = structured_packed(torch, d, n, 11, 0.1, 0.01, spec["seed"], dev)
    rows = tuple(x.cpu().numpy() for x in (packed, mean, std))
    del packed, mean, std
    torch.cuda.empty_cache()

    def source(i):
        return tuple(x[i * strip:(i + 1) * strip] for x in rows)

    sm = StreamingMatrix(source, -(-d // strip), d, n, strip, packed=True, device=dev)
    mesh.barrier()
    tk.reset_launch_counts()
    mesh.reset_collective_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = streamed_pca(sm, k=spec["k"], n_power_iter=4, seed=7, compute_loadings=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"rank": mesh.process_index(), "strips": len(sm.own_strips), "wall": wall,
            "launches": dict(tk.LAUNCHES), "collectives": dict(mesh.COLLECTIVES),
            "passes": [(t["pass"], t["seconds"], t.get("all_reduce_seconds"),
                        t.get("all_gather_seconds")) for t in sm.pass_log],
            "scores": res.scores, "sigma": res.singular_values,
            "loadings_ok": bool(res.loadings.shape == (d, spec["k"])
                                and np.isfinite(res.loadings).all())}


def rank_streamed_eigensnp(spec):
    """Phase 17b on each rank: `run_eigensnp_workflow(force_streaming=True)`
    on phase 8's fileset; returns the launches, the wall and the log lines
    of the container, the QC and each streamed pass."""
    import torch

    from genomic_pca_tpu_torch.ops import kernels as tk
    from genomic_pca_tpu_torch.parallel import mesh
    from genomic_pca_tpu_torch.workflows import (
        DataPrepConfig, EigenSnpConfig, run_eigensnp_workflow,
    )

    dev = mesh.rank_device("cuda")
    with Captured() as messages:
        mesh.barrier()
        tk.reset_launch_counts()
        t0 = time.perf_counter()
        run_eigensnp_workflow(
            DataPrepConfig(bed_path=spec["bed"], ld_block_path=f"{spec['bed']}.blocks.tsv"),
            EigenSnpConfig(), spec["out"], write_moments=True, device=dev,
            force_streaming=True)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    keep = ("Host-streamed container", "Distributed SNP QC", "SNP QC:", "Streamed pass",
            "Memory preflight", "EigenSNP stage split:")
    return {"rank": mesh.process_index(), "wall": wall, "launches": dict(tk.LAUNCHES),
            "messages": [m for m in messages if m.startswith(keep)]}


def check_streamed_ranks(torch, np, device, streamed_main, fileset):
    """Phase 17 (module docstring)."""
    from genomic_pca_tpu_torch.eval.multichip import run_ranks

    # (a) streamed_pca over two ranks against phase 14a.
    label = "ranks 2 streamed 1-D"
    ref_launches, ref_scores, oracle = streamed_main
    t0 = time.perf_counter()
    outs = run_ranks(rank_streamed_path, 2, ({"d": 262_144, "n": 2048, "strip": 2048,
                                              "seed": SEED + 2, "k": 10},),
                     device="cuda", timeout_s=600)
    spawn_wall = time.perf_counter() - t0
    total = dict(ZERO_LAUNCHES)
    for out in outs:
        log(f"[{label}] rank {out['rank']}: {out['strips']} strips; streamed_pca wall "
            f"{out['wall']:.3f} s; launches {out['launches']}; collectives "
            f"{out['collectives']}")
        for name, secs, ar, ag in out["passes"]:
            log(f"[{label}] rank {out['rank']} pass {name}: {secs:.3f} s, all-reduce "
                f"{ar if ar is None else round(ar, 4)} s, all-gather "
                f"{ag if ag is None else round(ag, 4)} s")
        for name, count in out["launches"].items():
            total[name] += count
        want = dict(ZERO_LAUNCHES, fused_gram_q8_packed=3 * out["strips"],
                    fused_gram_apply_packed=out["strips"],
                    fused_right_apply_packed=out["strips"])
        if out["launches"] != want:
            raise AssertionError(f"{label}: rank {out['rank']} launches "
                                 f"{out['launches']} != {want}")
        if not out["loadings_ok"] or not np.array_equal(out["scores"], outs[0]["scores"]):
            raise AssertionError(f"{label}: ranks disagree or bad loadings")
    log(f"[{label}] two spawned ranks in {spawn_wall:.1f} s; launches summed over the "
        f"ranks {total}")
    if total != ref_launches:
        raise AssertionError(f"{label}: summed launches {total} != phase 14a's "
                             f"{ref_launches}")
    sep, _, _ = check_pcs(np, outs[0]["scores"], *oracle,
                          outs[0]["sigma"].astype(np.float64) ** 2, 10, label)
    r_min, cos = per_pc_agreement(np, outs[0]["scores"], ref_scores, sep)
    log(f"[{label}] against phase 14a's one-rank streamed run: min |r| {r_min:.7f}, "
        f"min principal cosine {cos:.7f}")
    if r_min <= 0.999 or cos <= 0.999:
        raise AssertionError(f"{label}: two ranks and one rank disagree")
    del outs
    torch.cuda.empty_cache()

    # (b) EigenSNP with force_streaming over two ranks, in process.
    label = "ranks 2 streamed eigensnp"
    prefix, _ref_pcs, oracle, _sep = fileset
    out = FILESET / "streamed_ranks2"
    t0 = time.perf_counter()
    outs = run_ranks(rank_streamed_eigensnp, 2, ({"bed": str(prefix), "out": str(out)},),
                     device="cuda", timeout_s=900)
    spawn_wall = time.perf_counter() - t0
    n_snps = sum(1 for _ in open(f"{out}.eigensnp.loadings.tsv")) - 1
    strips = -(-n_snps // 2000)
    total = dict(ZERO_LAUNCHES)
    for o in outs:
        log_messages(f"{label} rank {o['rank']}", o["messages"], ("",))
        log(f"[{label}] rank {o['rank']}: run_eigensnp_workflow(force_streaming=True) "
            f"in {o['wall']:.2f} s; launches {o['launches']}")
        for name, count in o["launches"].items():
            total[name] += count
    want = dict(ZERO_LAUNCHES, fused_right_apply_2d_packed=2 * strips,
                fused_left_apply_2d_packed=strips)
    same = (Path(f"{out}.eigensnp.moments.tsv").read_bytes()
            == (FILESET / "out.eigensnp.moments.tsv").read_bytes())
    log(f"[{label}] two spawned ranks in {spawn_wall:.1f} s; {strips} strips; "
        f"launches summed over the ranks {total}; moments TSV byte for byte phase "
        f"8's: {same}")
    if total != want or not same:
        raise AssertionError(f"{label}: launches {total} != {want} or moments differ")
    pcs = np.loadtxt(f"{out}.eigensnp.pca.tsv", skiprows=1, usecols=range(1, 11),
                     delimiter="\t")
    evs = np.loadtxt(f"{out}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    check_pcs(np, pcs, *oracle, evs * (pcs.shape[0] - 1), 10, label)

    # (c) The two-rank EigenSNP CLI with the device scan: each rank's unit
    # from its own QC capture, against phase 15d's host scan and re-read.
    label = "ranks 2 device scan cli"
    out = FILESET / "ranks2_device"
    msgs, wall = torchrun(["--eigensnp", "--bed-file", str(prefix), "--ld-block-file",
                           f"{prefix}.blocks.tsv", "-o", str(out), "--write-moments",
                           "--eigensnp-qc-mode", "device"], label)
    log_messages(label, msgs, ("Distributed SNP QC", "SNP QC:", "QC->matrix capture",
                               "Rank 0/2 holds", "EigenSNP stage split:",
                               "Total run time"))
    launches = kernel_launches(msgs)
    same = (Path(f"{out}.eigensnp.moments.tsv").read_bytes()
            == (FILESET / "ranks2.eigensnp.moments.tsv").read_bytes())
    log(f"[{label}] torch.distributed.run --nproc-per-node 2 exit 0 in {wall:.2f} s; "
        f"rank 0 launches {launches}; moments TSV byte for byte phase 15d's: {same}")
    want = dict(ZERO_LAUNCHES, fused_right_apply_2d_packed=3,
                fused_left_apply_2d_packed=1)
    if launches != want or not same:
        raise AssertionError(f"{label}: launches {launches} or moments differ")
    if not any(m.startswith("Rank 0/2 holds") and "from its QC capture" in m
               for m in msgs):
        raise AssertionError(f"{label}: rank 0's unit was not assembled from its capture")
    pcs = np.loadtxt(f"{out}.eigensnp.pca.tsv", skiprows=1, usecols=range(1, 11),
                     delimiter="\t")
    evs = np.loadtxt(f"{out}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    check_pcs(np, pcs, *oracle, evs * (pcs.shape[0] - 1), 10, label)


# ---------------------------------------------------------------------------
# Phase 19: the oracles and the eval chain.


def rel_err(got, ref) -> float:
    """max|got - ref| / max|ref| (host arrays or tensors)."""
    import numpy as np

    got = got if isinstance(got, np.ndarray) else got.cpu().numpy()
    ref = ref if isinstance(ref, np.ndarray) else ref.cpu().numpy()
    return float(np.abs(got.astype(np.float64) - ref).max() / np.abs(ref).max())


def exact_agreement(np, scores, evals, ref_scores, ref_evals, label, ev_rtol):
    """Per-PC |r| >= 1 - 1e-9 over the separated prefix of `ref_evals` (k +
    1 values) and eigenvalues within `ev_rtol`: two exact PCAs of the same
    strips."""
    k = len(ref_evals) - 1
    sep = separated_prefix(ref_evals, k)
    rs = [abs(float(np.corrcoef(scores[:, j], ref_scores[:, j])[0, 1]))
          for j in range(sep)]
    ev = float(np.max(np.abs(evals[:k] - ref_evals[:k]) / ref_evals[:k]))
    if sep < 1:
        raise AssertionError(f"{label}: no eigengap-separated PC to check")
    log(f"[{label}] separated prefix {sep}/{k}; min |r| {min(rs):.12f}; max "
        f"eigenvalue rel err {ev:.3e}")
    if min(rs) < 1 - 1e-9 or ev > ev_rtol:
        raise AssertionError(f"{label}: exact PCAs disagree: |r| {rs}, eigenvalue "
                             f"rel err {ev} (bound {ev_rtol})")


def check_striped(torch, np, device, d, n, k, seed):
    """Phase 19c: `StripedMatrix` (plain f32 products) on the card against
    the resident container in both layouts (f32 kernels, the same
    moments) pass by pass, then `streamed_pca` over it (the plain power
    loop) against the port's float64 oracle."""
    from genomic_pca_tpu_torch.models.exact import exact_pca_from_strips
    from genomic_pca_tpu_torch.models.pca import streamed_pca
    from genomic_pca_tpu_torch.ops.stream import StripedMatrix
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, host_moments

    label = "striped"
    packed, _, _ = structured_packed(torch, d, n, 11, 0.1, 0.01, seed, device)
    g = dense_from_packed(torch, packed).cpu().numpy()
    packed_np = packed.cpu().numpy()
    del packed
    mean, std = host_moments(g)
    t0 = time.perf_counter()
    oracle = StripedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                       strip_size=2048, device=device)
    log(f"[{label}] StripedMatrix {d} x {n} in {len(oracle.strips)} strips, "
        f"built in {time.perf_counter() - t0:.2f} s")
    b = torch.linalg.qr(torch.randn((n, 128), generator=torch.Generator().manual_seed(seed),
                                    dtype=torch.float32))[0].to(device)
    for layout, sm in (
        ("packed", ShardedMatrix.from_packed_rows(packed_np, mean, std, n, device,
                                                  kernel_precision="f32")),
        ("dense", ShardedMatrix.from_arrays(iter([g]), means=[mean], stds=[std],
                                            device=device, kernel_precision="f32")),
    ):
        errs = {}
        for name in ("gram_apply", "tsq_accumulate", "right_apply"):
            errs[name] = rel_err(getattr(sm, name)(b), getattr(oracle, name)(b))
        log(f"[{label}] resident {layout} container ({sm.mode} mode, f32 kernels) "
            f"against StripedMatrix, max|diff| / max|oracle|: "
            + ", ".join(f"{k_} {v:.2e}" for k_, v in errs.items()))
        if max(errs.values()) > 1e-5:
            raise AssertionError(f"{label}: the {layout} container disagrees with "
                                 f"StripedMatrix: {errs}")
        del sm
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = streamed_pca(oracle, k=k, n_power_iter=4, seed=7, compute_loadings=True)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if (res.scores.shape != (n, k) or res.loadings.shape != (d, k)
            or not np.isfinite(res.scores).all() or res.n_iter_done != 4):
        raise AssertionError(f"{label}: streamed_pca output has the wrong shape, "
                             f"non-finite values or {res.n_iter_done} passes")
    t0 = time.perf_counter()
    exact = exact_pca_from_strips((g[lo:lo + 8192] for lo in range(0, d, 8192)), n,
                                  k + 1, scale=True, apply_qc=False, device=device)
    log(f"[{label}] streamed_pca (the plain power loop, 4 passes) in {wall:.3f} s; "
        f"float64 oracle in {time.perf_counter() - t0:.2f} s")
    check_pcs(np, res.scores, exact.scores, exact.eigenvalues * exact.n_kept_variants,
              res.singular_values.astype(np.float64) ** 2, k, label)


def check_eval_chain(torch, np, device):
    """Phase 19 (module docstring): the 1000G-like cohort, the exact
    oracle CLI on the card against the oracle on the CPU, StripedMatrix,
    and five sweep runs of the EigenSNP CLI, the base run against the
    float64 oracle over its QC'd SNPs."""
    from genomic_pca_tpu_torch.config import DataPrepConfig
    from genomic_pca_tpu_torch.eval import make_1000g_like, sweep_run
    from genomic_pca_tpu_torch.io.bed import BedReader
    from genomic_pca_tpu_torch.models.exact import exact_pca_from_strips

    t_phase = time.perf_counter()
    if G1K.exists():
        shutil.rmtree(G1K)
    # (a) The cohort of eval_artifacts/README.md.
    label = "eval cohort"
    t0 = time.perf_counter()
    bed, _, blocks = make_1000g_like.make_dataset(str(G1K), 60_000, 2504, 120, 2025)
    log(f"[{label}] make_1000g_like 60,000 SNPs x 2,504 samples, 120 LD blocks, seed "
        f"2025 in {time.perf_counter() - t0:.1f} s")

    # (b) The exact oracle CLI on the card, against the oracle on the CPU.
    label = "exact cli"
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "genomic_pca_tpu_torch.eval.exact", "--bed-prefix", bed,
         "--out-dir", str(G1K / "exact")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=600)
    exact_wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: exit {proc.returncode}:\n{proc.stderr[-4000:]}")
    log_messages(label, [line.split("] ", 1)[-1] for line in proc.stderr.splitlines()],
                 ("GRM built", "Total wall-time"))
    log(f"[{label}] python -m genomic_pca_tpu_torch.eval.exact exit 0 in "
        f"{exact_wall:.2f} s")
    reader = BedReader(bed)
    n = reader.n_samples
    strips = [reader.read(slice(lo, min(lo + 2000, reader.n_snps)), count_a1=False)
              for lo in range(0, reader.n_snps, 2000)]
    cfg = DataPrepConfig(min_call_rate=0.98, min_maf=0.01, max_hwe_p=1e-6,
                         min_variance=1e-9)
    walls = {}
    runs = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        runs[dev] = exact_pca_from_strips(iter(strips), n, 11, config=cfg, device=dev)
        walls[dev] = time.perf_counter() - t0
    gpu, cpu = runs["cuda"], runs["cpu"]
    log(f"[{label}] exact_pca_from_strips in process: {gpu.n_kept_variants} SNPs kept; "
        f"{walls['cuda']:.2f} s on the card, {walls['cpu']:.2f} s on the CPU")
    if gpu.n_kept_variants != cpu.n_kept_variants:
        raise AssertionError(f"{label}: kept {gpu.n_kept_variants} != "
                             f"{cpu.n_kept_variants} SNPs")
    exact_agreement(np, gpu.scores, gpu.eigenvalues, cpu.scores, cpu.eigenvalues,
                    "exact card vs CPU", 1e-9)
    pcs = np.loadtxt(G1K / "exact" / "pca.tsv", skiprows=1, usecols=range(10),
                     delimiter="\t")
    evs = np.loadtxt(G1K / "exact" / "py.eigenvalues.tsv", skiprows=1, usecols=1,
                     delimiter="\t")
    with open(G1K / "exact" / "pca.tsv") as fh:
        head = fh.readline().rstrip("\n").split("\t")
    if head != [f"PC{i}" for i in range(1, 11)] + ["SampleID"] or pcs.shape != (n, 10):
        raise AssertionError(f"{label}: pca.tsv layout {head}, shape {pcs.shape}")
    # The TSVs hold %.6g: eigenvalues to 6 significant digits.
    exact_agreement(np, pcs, evs, cpu.scores, cpu.eigenvalues, "exact cli TSVs vs CPU",
                    1e-5)
    del strips, runs
    torch.cuda.empty_cache()

    # (c) The test-oracle container on the card.
    check_striped(torch, np, device, 65_536, 2048, 10, SEED + 15)
    torch.cuda.empty_cache()

    # (d) Five runs of the sweep: the base defaults and one value of four knobs.
    label = "sweep"
    sweeps = {"eigensnp_min_maf": [0.03], "eigensnp_components_per_block": [18],
              "eigensnp_local_power_iter": [5], "eigensnp_refine_passes": [4]}
    configs = sweep_run.generate_run_configs(G1K / "sweeps", 4, sweeps=sweeps)
    # Each run is `python -m genomic_pca_tpu_torch` in a child process.
    os.environ["PYTHONPATH"] = env["PYTHONPATH"]
    if len(configs) != 5:
        raise AssertionError(f"{label}: {len(configs)} run configs, not 5")
    for cfg_run in configs:
        res = sweep_run.execute_single_run((cfg_run, bed, blocks))
        prefix = Path(cfg_run["output_prefix"])
        log(f"[{label}] {res['run_id']}: success {res['success']} in "
            f"{res['duration_seconds']} s")
        if not res["success"]:
            err = (Path(cfg_run["output_dir"]) / "stderr.log").read_text()
            raise AssertionError(f"{label}: {res['run_id']} failed:\n{err[-4000:]}")
        with open(f"{prefix}.eigensnp.pca.tsv") as fh:
            pc_head = fh.readline().rstrip("\n").split("\t")
        with open(f"{prefix}.eigensnp.loadings.tsv") as fh:
            l_head = fh.readline().rstrip("\n").split("\t")
        with open(f"{prefix}.eigenvalues.tsv") as fh:
            e_head = fh.readline().rstrip("\n").split("\t")
        if (pc_head != ["SampleID"] + [f"PC{i}" for i in range(1, 11)]
                or l_head[:3] != ["VariantID", "Chrom", "Pos"]
                or e_head != ["PC", "Eigenvalue"]):
            raise AssertionError(f"{label}: {res['run_id']} TSV headers {pc_head[:3]}, "
                                 f"{l_head[:4]}, {e_head}")
    base = Path(configs[0]["output_prefix"])
    pcs = np.loadtxt(f"{base}.eigensnp.pca.tsv", skiprows=1, usecols=range(1, 11),
                     delimiter="\t")
    evs = np.loadtxt(f"{base}.eigenvalues.tsv", skiprows=1, usecols=1, delimiter="\t")
    with open(f"{base}.eigensnp.loadings.tsv") as fh:
        fh.readline()
        ids = [line.split("\t", 1)[0] for line in fh]
    row = {sid: i for i, sid in enumerate(reader.bim.sid)}
    sel = np.array([row[sid] for sid in ids])
    raw = reader.read(sel)
    exact = exact_pca_from_strips((raw[lo:lo + 8192] for lo in range(0, len(sel), 8192)),
                                  n, 11, scale=True, apply_qc=False, device=device)
    log(f"[{label}] base run: {len(ids)} PCA SNPs; the float64 oracle over them "
        f"(scaled, no QC)")
    if pcs.shape != (n, 10) or not np.isfinite(pcs).all():
        raise AssertionError(f"{label}: base run scores {pcs.shape} or non-finite")
    check_pcs(np, pcs, exact.scores, exact.eigenvalues * exact.n_kept_variants,
              evs * (n - 1), 10, "sweep base run")
    shutil.rmtree(G1K)
    log(f"[eval chain] phase 19 in {time.perf_counter() - t_phase:.1f} s (the exact "
        f"CLI {exact_wall:.2f} s)")


# ---------------------------------------------------------------------------
# Phase 20: the bench on the card.

BENCH_TMP = ROOT / "build" / "chip_smoke_bench"  # phase 20's temp directory
# Kernel 1's raw launch at 262,144 x 2,048 (PERF.md section 6: 0.5836 ms);
# every iteration of the headline loop holds one.
KERNEL1_RAW_MS = 0.5836
# Phase 20b: the full biobank width at a reduced depth (1,024 SNPs a block).
BIOBANK_SAMPLES = 102_400
BIOBANK_SNPS = 32_768
ORACLE_R_MIN = 0.97
RESIDUAL_RTOL = 1e-4


def run_module(module, args, label, timeout):
    """`python -m <module> <args>` with the temp directory under BENCH_TMP:
    (stdout, stderr lines, wall); a nonzero exit raises with the stderr's
    end."""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(ROOT), env.get("PYTHONPATH", "")])
    env["TMPDIR"] = str(BENCH_TMP)
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"{label}: python -m {module} exit {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-6000:]}")
    return proc.stdout, proc.stderr.splitlines(), wall


def bench_launches(lines):
    """{row: launches} from the bench's "Kernel launches <row>: {...}" lines."""
    out = {}
    for line in lines:
        if line.startswith("Kernel launches "):
            row, counts = line[len("Kernel launches "):].split(": ", 1)
            out[row] = json.loads(counts)
    return out


def check_bench(torch, np):
    """Phase 20 (module docstring)."""
    t_phase = time.perf_counter()
    shutil.rmtree(BENCH_TMP, ignore_errors=True)
    BENCH_TMP.mkdir(parents=True)

    # (a) The bench: its JSON line, its launches per row, the oracle.
    label = "bench"
    out, err, wall = run_module("genomic_pca_tpu_torch.bench", [], label, 900)
    line = json.loads(out.strip().splitlines()[-1])
    d = line["detail"]
    log(f"[{label}] python -m genomic_pca_tpu_torch.bench exit 0 in {wall:.1f} s; "
        f"nvidia-smi: {smi_line()}")
    log(f"[{label}] {json.dumps(line)}")
    errors = [k for k in d if k.endswith("_error")]
    if errors:
        raise AssertionError(f"{label}: rows failed: {errors}")
    if d["value_method"] != "trace_device_time":
        raise AssertionError(f"{label}: value_method {d['value_method']}")
    tr = d["trace_device_ms_per_iter"]
    if not tr.get("packed_q8", 0) > KERNEL1_RAW_MS:
        raise AssertionError(f"{label}: device ms per iteration {tr} is not above "
                             f"kernel 1's {KERNEL1_RAW_MS} ms")
    launches = bench_launches(err)
    for row, counts in launches.items():
        log(f"[{label}] launches {row}: {counts}")
    for line_ in err:
        if line_.startswith("biobank_e2e container"):
            log(f"[{label}] {line_}")
    from genomic_pca_tpu_torch.bench import CARD

    n_it = CARD.it_lo  # the traced loop: q8 steering passes, 1 exact polish
    want = {"packed_q8": {"fused_gram_q8_packed": n_it - 1, "fused_gram_apply_packed": 1},
            "dense_q8": {"fused_gram_q8": n_it - 1, "fused_gram_apply": 1},
            "dense_bf16": {"fused_gram_apply": n_it}}
    for row, counts in want.items():
        if launches.get(row) != counts:
            raise AssertionError(f"{label}: {row} launches {launches.get(row)} != {counts}")
    legs = [launches[f"biobank_e2e {leg}"] for leg in d["biobank_e2e_legs_seconds"]]
    reached = set().union(*legs)
    if not reached or reached - set(KERNELS_2D):
        raise AssertionError(f"{label}: the compact biobank legs launched {legs}, "
                             "not 2-D kernels only")
    r_min = d["biobank_e2e_per_pc_abs_r_min_separated"]
    if not r_min > ORACLE_R_MIN:
        raise AssertionError(f"{label}: compact biobank subset oracle min |r| {r_min} "
                             f"<= {ORACLE_R_MIN}")
    shutil.rmtree(BENCH_TMP / f"gptpu_torch_bench_bio_{d['biobank_e2e_snps']}x"
                  f"{d['biobank_e2e_samples']}")

    # (b) The biobank script at full width, reduced depth: the workflow, the
    # residual certificate on both backends, the subset oracle.
    label = "biobank"
    blocks = BIOBANK_SNPS // 1024
    log(f"[{label}] {BIOBANK_SNPS:,} SNPs x {BIOBANK_SAMPLES:,} samples, {blocks} LD "
        f"blocks, k = 40: the full-scale width at a depth cut from 1,048,576 SNPs "
        f"to keep this phase near 4 minutes")
    args = ["--out-dir", str(BENCH_TMP / "biobank"), "--snps", str(BIOBANK_SNPS),
            "--samples", str(BIOBANK_SAMPLES), "--blocks", str(blocks)]
    out, err, wall = run_module("genomic_pca_tpu_torch.eval.biobank_bench",
                                args + ["--residual-backend", "device"], label, 900)
    run = json.loads(out)
    log(f"[{label}] workflow, device residual and oracle in {wall:.1f} s: "
        f"{json.dumps(run)}")
    for line_ in err:
        if line_.lstrip().startswith("[leg]") or "Kernel launches" in line_:
            log(f"[{label}] {line_.strip()}")
    out, _, wall = run_module("genomic_pca_tpu_torch.eval.biobank_bench",
                              args + ["--skip-run", "--skip-oracle",
                                      "--residual-backend", "host"], label, 900)
    host = json.loads(out)["residual"]
    dev = run["residual"]
    rel = np.abs(np.asarray(dev["residual_per_pc_unrounded"])
                 / np.asarray(host["residual_per_pc_unrounded"]) - 1)
    log(f"[{label}] host residual in {wall:.1f} s ({host['seconds']} s inside): max "
        f"{host['max_residual']}; device {dev['seconds']} s: max {dev['max_residual']}; "
        f"per PC max relative difference {rel.max():.3e}")
    if not rel.max() <= RESIDUAL_RTOL:
        raise AssertionError(f"{label}: the residual backends differ by {rel.max():.3e} "
                             f"> {RESIDUAL_RTOL}: {rel.tolist()}")
    if run["workflow"]["container"] != "device-resident 2d":
        raise AssertionError(f"{label}: container {run['workflow']['container']}")
    shutil.rmtree(BENCH_TMP)
    log(f"[bench] phase 20 in {time.perf_counter() - t_phase:.1f} s")


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
    # A streamed 1-D strip of the gram pass: both products' plans split.
    check_kernels(torch, 2_048, 2_048, SEED + 12, device, 5,
                  ("fused_gram_apply_packed",), ties_allowed=True)
    # The streamed strip's right products: the loadings (L = 10, the narrow
    # kernel's samples split) and the tsq pass's (L = 128, the wide route).
    for right1d_ell in (10, 128):
        check_kernels(torch, 2_048, 2_048, SEED + 12, device, 5,
                      ("fused_right_apply_packed",), right1d_ell=right1d_ell)
    # The streamed strip's q8 pass: the right product's samples split, the
    # left product's rows in 2 ranges.
    check_kernels(torch, 2_048, 2_048, SEED + 12, device, 5, ("fused_gram_q8_packed",))

    # 4. The 2-D kernels at the wide shape and a ragged one; both modes.
    results.update(check_kernels(torch, 65_536, 16_384, SEED + 6, device, 5,
                                 KERNELS_2D))
    check_kernels(torch, 70_001, 16_389, SEED + 7, device, 3, KERNELS_2D)
    # The thinnest grids of kernels 5-8: a streamed strip at the switch
    # width (8's rows split), an EigenSNP strip (5's and 7's samples split,
    # 8's last row tile ragged), 8 at row tiles of 64 on both, 8 at the
    # 1-D width (its rows split 8 ways; on no path yet), and the loadings
    # launch of kernel 5 (L = k = 10).
    check_kernels(torch, 2_048, 11_264, SEED + 10, device, 5,
                  ("fused_right_apply_2d_packed", "fused_left_apply_2d_packed",
                   "right_apply_2d_q8", "left_apply_2d_q8"))
    check_kernels(torch, 2_000, 16_384, SEED + 11, device, 5,
                  ("fused_right_apply_2d_packed", "right_apply_2d_q8",
                   "left_apply_2d_q8"))
    for d, n in ((2_048, 11_264), (2_000, 16_384)):
        check_kernels(torch, d, n, SEED + 11, device, 3, ("left_apply_2d_q8",),
                      q8_tile=64)
    check_kernels(torch, 262_144, 2_048, SEED + 13, device, 3, ("left_apply_2d_q8",))
    check_kernels(torch, 65_536, 16_384, SEED + 6, device, 3,
                  ("fused_right_apply_2d_packed",), ell=10)
    compare_modes(torch, np, 65_536, 16_384, SEED + 6, device, 5)
    for d, n in ((65_536, 16_384), (2_048, 11_264)):
        check_q8_pass_2d(torch, d, n, SEED + 14, device)
    torch.cuda.empty_cache()

    # 5-6. The main path in each mode.
    launches = {}
    main = {}
    main_res = {}
    for label, d, n, seed, want in (
        ("main 1-D", 262_144, 2048, SEED + 2,
         {"fused_gram_q8_packed": 3, "fused_gram_apply_packed": 1,
          "fused_tsq_packed": 1, "fused_right_apply_packed": 1}),
        ("main 2-D", 131_072, 16_384, SEED + 4,
         {"fused_right_apply_2d_packed": 3, "fused_left_apply_2d_packed": 1,
          "right_apply_2d_q8": 3, "left_apply_2d_q8": 3}),
    ):
        got, res, oracle, sep = check_main(torch, np, device, label, d, n, 10,
                                           seed)
        if got != dict(ZERO_LAUNCHES, **want):
            raise AssertionError(f"{label}: launch counts {got} != {want}")
        launches.update({name: got[name] for name in want})
        main[label] = (res.scores, oracle, sep)
        main_res[label] = res
        torch.cuda.empty_cache()

    # 7. The VCF CLI on VCF directories of 1000 Genomes phase 3 width:
    # 32,768 variants of 5 populations (4 structured PCs; PCs 5-10 lie in
    # the noise bulk, where only the Ritz lower bound is checked), and
    # 65,536 variants of 11 populations (10 structured PCs).
    check_cli(torch, np, device, 32_768, 8, 5, SEED + 3, 10, profile=True)
    vcf_run = check_cli(torch, np, device, 65_536, 16, 11, SEED + 3, 10, keep=True)

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
    check_kernels(torch, 2_048, 2_048, SEED + 12, device, 5, ("fused_gram_apply",),
                  ties_allowed=True)
    for right1d_ell in (10, 128):
        check_kernels(torch, 2_048, 2_048, SEED + 12, device, 5,
                      ("fused_right_apply",), right1d_ell=right1d_ell)
    check_kernels(torch, 2_048, 2_048, SEED + 12, device, 5, ("fused_gram_q8",))
    torch.cuda.empty_cache()

    # 10. The dense main path on the genotypes of the packed one.
    packed_scores, oracle, sep = main["main 1-D"]
    got, res, _, _ = check_main(torch, np, device, "main dense 1-D", 262_144,
                                2048, 10, SEED + 2, dense=True, oracle=oracle)
    scores = res.scores
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
    dense_prefix = check_dense_eigensnp_and_projection(torch, np, device, 65_536,
                                                       10_000, 64, 10, SEED + 8)

    # 12. The dense 2-D kernels at the 2-D kernel shape and a ragged one.
    results.update(check_kernels(torch, 65_536, 16_384, SEED + 6, device, 5,
                                 KERNELS_DENSE_2D))
    check_kernels(torch, 70_001, 16_389, SEED + 7, device, 3, KERNELS_DENSE_2D)
    check_kernels(torch, 2_048, 11_264, SEED + 10, device, 5,
                  ("fused_right_apply_2d", "fused_left_apply_2d", "right_apply_2d_q8_i8",
                   "left_apply_2d_q8_i8"))
    check_kernels(torch, 2_000, 16_384, SEED + 11, device, 5,
                  ("fused_right_apply_2d", "right_apply_2d_q8_i8", "left_apply_2d_q8_i8"))
    for d, n in ((2_048, 11_264), (2_000, 16_384)):
        check_kernels(torch, d, n, SEED + 11, device, 3, ("left_apply_2d_q8_i8",),
                      q8_tile=64)
    check_kernels(torch, 262_144, 2_048, SEED + 13, device, 3, ("left_apply_2d_q8_i8",))
    check_kernels(torch, 65_536, 16_384, SEED + 6, device, 3,
                  ("fused_right_apply_2d",), ell=10)
    for d, n in ((65_536, 16_384), (2_048, 11_264)):
        check_q8_pass_2d(torch, d, n, SEED + 14, device, dense=True)
    torch.cuda.empty_cache()

    # 13. The dense 2-D main path on the genotypes of the packed 2-D one.
    packed_scores, oracle, sep = main["main 2-D"]
    got, res, _, _ = check_main(torch, np, device, "main dense 2-D", 131_072,
                                16_384, 10, SEED + 4, dense=True, oracle=oracle)
    scores = res.scores
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
    streamed_launches, streamed_scores = check_streamed_main(
        torch, np, device, 262_144, 2048, 10, SEED + 2, 2048, main["main 1-D"])
    check_streamed_eigensnp(torch, np, device, fileset, 10, packed_pipeline=True)
    check_streamed_eigensnp(torch, np, device, fileset, 10, packed_pipeline=False)

    # 15. Several ranks: a process group of one (NCCL), two ranks on the
    # card (gloo) through the 1-D and 2-D main paths, and the VCF and
    # EigenSNP CLIs under torch.distributed.run on phases 7 and 8's data.
    check_multirank(torch, np, device, main, main_res, vcf_run, fileset)
    shutil.rmtree(VCF_KEPT)

    # 16. The device QC scan and its capture: the EigenSNP CLI with
    # --eigensnp-qc-mode device on phase 8's fileset, the captured
    # containers against the re-read ones (packed; dense on phase 11's).
    check_device_scan(torch, np, device, fileset, dense_prefix)
    shutil.rmtree(DENSE_KEPT)

    # 17. The host-streamed container over two ranks on the card: the
    # streamed 1-D main path, EigenSNP with force_streaming, and the
    # two-rank CLI with the device scan (the multi-rank capture).
    check_streamed_ranks(torch, np, device,
                         (streamed_launches, streamed_scores, main["main 1-D"][1]),
                         fileset)
    shutil.rmtree(FILESET)

    # 19. The oracles and the eval chain: the 1000G-like cohort, the exact
    # oracle CLI on the card, StripedMatrix against the resident container
    # and the float64 oracle, and five EigenSNP sweep runs.
    check_eval_chain(torch, np, device)

    # 20. The bench on the card: its JSON line (device time, launches per
    # row, the compact biobank oracle), then the biobank script at the full
    # width with both residual backends and the subset oracle.
    check_bench(torch, np)

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

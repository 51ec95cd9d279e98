"""Benchmark of the port: the packed q8 power loop on one GPU.

    python -m genomic_pca_tpu_torch.bench               # on the card
    python -m genomic_pca_tpu_torch.bench --biobank     # full-scale biobank run
    python -m genomic_pca_tpu_torch.bench --device cpu  # CPU shapes, wall clock

Counterpart of the JAX package's root `bench.py`, which stays that
package's bench.  Measures the hot loop of the randomized-PCA core, the
q8 power-iteration pass A^T A B, through the production container layout:
PLINK 2-bit packed genotypes resident on the card (`ShardedMatrix(...,
kernel_precision="q8")`, `models.pca.power_iterate`: kernel 1 `fused_gram_q8_packed`
for the steering passes, kernel 2 for the one exact polish pass), at
262,144 SNPs x 2,048 samples and L = 128.  Genotypes are made on the card
from a seeded `torch.Generator` (two Bernoulli draws against a per-SNP
byte threshold), their moments exactly on the card, and packed to PLINK
codes on the card.

The headline `value` is SNPs per second of DEVICE time: one power loop
traced under torch.profiler, the device time of every kernel, memcpy and
memset in it summed and divided by the iteration count.  On the card a
trace with no device time is an error.  The marginal wall-clock rate (the
slope between loops of 64 and 192 iterations, each the best of 3, with the
noise guard of the JAX bench) is `detail.marginal_snps_per_sec`.  Detail
rows: the dense int8 q8 loop (kernel 9, kernel 10's polish) and the dense
bf16 loop (kernel 10); a compact EigenSNP run cold then warm in process
(32,768 x 1,024); a compact biobank run (98,304 x 49,152, k = 40, the 2-D
container) through `eval/biobank_bench.py` with its subset oracle.
`vs_baseline` is the marginal rate over the numpy float64 Gram
accumulation of the reference's exact-PCA oracle on this host, wall
against wall.  The kernel launches of each row go to standard error as
"Kernel launches <row>: {...}".

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline",
"detail"}.  A failed row keeps its `*_error` key in the line, and the
process then exits 1.  Without a card it refuses unless `--device cpu`
is given, which takes the JAX bench's CPU shapes and reports wall-clock
rates only.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import logging
import sys
import tempfile
import time
import traceback
from pathlib import Path
from typing import List, Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.models.pca import power_iterate

log = logging.getLogger("genomic_pca_tpu_torch.bench")

LAUNCHES_PREFIX = "Kernel launches "


@dataclasses.dataclass(frozen=True)
class Shapes:
    """Sizes of one bench run: the power loop's matrix, sketch width and
    two iteration counts; the compact EigenSNP run; the compact biobank
    run with its block count, k and subset oracle."""

    n_snps: int
    n_samples: int
    ell: int
    it_lo: int
    it_hi: int
    e2e: tuple
    bio: tuple
    bio_blocks: int = 96
    bio_k: int = 40
    oracle_blocks: int = 48
    oracle_samples: int = 4096


# The JAX bench's shapes (bench.py:64-66, :121, :212, :260), on the card
# and under --device cpu.
CARD = Shapes(262_144, 2048, 128, 64, 192, (32_768, 1024), (98_304, 49_152))
CPU = Shapes(16_384, 2048, 128, 8, 24, (4096, 256), (8192, 1024))
# `--biobank`: the JAX bench's full-scale configuration (bench.py:418-455).
BIOBANK = dict(d=1_048_576, n=102_400, k=40, n_blocks=1024, seed=2025)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _host_dosages(rng, n_snps: int, n_samples: int) -> np.ndarray:
    """Small host-side synthetic dosage block (the same Bernoulli scheme)."""
    thresh = rng.integers(8, 128, size=(n_snps, 1), dtype=np.uint8)
    r1 = rng.integers(0, 256, size=(n_snps, n_samples), dtype=np.uint8)
    r2 = rng.integers(0, 256, size=(n_snps, n_samples), dtype=np.uint8)
    return ((r1 < thresh).astype(np.int8) + (r2 < thresh)).astype(np.int8)


def make_data(n_snps: int, n_samples: int, device: torch.device, seed: int = 0):
    """(g (D, N) int8 dosages, mean (D, 1), inv_std (D, 1)) made on
    `device`: two Bernoulli draws against a per-SNP byte threshold, exact
    moments (ddof 1)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    thresh = torch.randint(8, 128, (n_snps, 1), generator=gen, device=device,
                           dtype=torch.uint8)
    r1 = torch.randint(0, 256, (n_snps, n_samples), generator=gen,
                       device=device, dtype=torch.uint8)
    r2 = torch.randint(0, 256, (n_snps, n_samples), generator=gen,
                       device=device, dtype=torch.uint8)
    g = (r1 < thresh).to(torch.int8) + (r2 < thresh).to(torch.int8)
    del r1, r2
    n1 = (g == 1).sum(dim=1, dtype=torch.float32)
    n2 = (g == 2).sum(dim=1, dtype=torch.float32)
    mean = (n1 + 2.0 * n2) / n_samples
    ssd = (n1 + 4.0 * n2) - n_samples * mean * mean
    std = torch.sqrt(torch.clamp(ssd / (n_samples - 1), min=0.0))
    inv = torch.where(std > 0, 1.0 / torch.where(std > 0, std, 1.0),
                      torch.zeros_like(std))
    return g, mean[:, None], inv[:, None]


def _nonzero_launches() -> dict:
    from genomic_pca_tpu_torch.ops import kernels

    return {k: v for k, v in kernels.LAUNCHES.items() if v}


def _log_launches(row: str, launches: dict) -> None:
    print(f"{LAUNCHES_PREFIX}{row}: {json.dumps(launches)}", file=sys.stderr,
          flush=True)


def measure(sm, b, it_lo: int, it_hi: int, device: torch.device):
    """(seconds an iteration, method): the marginal slope between loops of
    `it_lo` and `it_hi` iterations (each the best of 3), or the direct
    rate of the longer loop when the slope is not in (0, 1.2 x direct]."""

    def loop(n_iter: int) -> None:
        power_iterate(sm, b, n_iter)
        _sync(device)

    loop(it_lo)
    loop(it_hi)

    def best(n_iter: int) -> float:
        dt = float("inf")
        for _rep in range(3):
            t0 = time.perf_counter()
            loop(n_iter)
            dt = min(dt, time.perf_counter() - t0)
        return dt

    hi = best(it_hi)
    slope = (hi - best(it_lo)) / (it_hi - it_lo)
    direct = hi / it_hi
    if not (0.0 < slope <= 1.2 * direct):
        return direct, "direct_fallback"
    return slope, "marginal"


def trace_ms_per_iter(sm, b, n_iter: int, row: str, device: torch.device) -> float:
    """Device ms an iteration: one `n_iter` loop traced under torch.profiler
    (CUDA activity), the self device time of every kernel, memcpy and
    memset summed, over `n_iter`.  Logs the loop's kernel launches and
    its device time by name.  A trace with no device time raises."""
    from torch.profiler import ProfilerActivity, profile

    from genomic_pca_tpu_torch.ops import kernels

    power_iterate(sm, b, n_iter)  # warm
    _sync(device)
    kernels.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        power_iterate(sm, b, n_iter)
        _sync(device)
    _log_launches(row, _nonzero_launches())
    rows = [(ev.key, ev.count, ev.self_device_time_total / 1e3)
            for ev in prof.key_averages()
            if str(ev.device_type).endswith("CUDA") and ev.self_device_time_total > 0]
    total = sum(r[2] for r in rows)
    if total <= 0:
        raise RuntimeError(f"{row}: the torch.profiler trace captured no device "
                           "time (no kernel, memcpy or memset)")
    for name, count, ms in sorted(rows, key=lambda r: -r[2]):
        log.info("trace %s: %9.3f ms x%-4d %s", row, ms, count, name[:90])
    return total / n_iter


def power_loop_rows(shapes: Shapes, device: torch.device, rng) -> dict:
    """The three power loops (packed q8, dense q8, dense bf16): seconds an
    iteration with its method, and device ms an iteration on the card."""
    from genomic_pca_tpu_torch.models.prepare import _pack_rows_device
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix, packed_cols

    n_snps, n_samples = shapes.n_snps, shapes.n_samples
    g, mean, inv = make_data(n_snps, n_samples, device)
    b = torch.as_tensor(rng.standard_normal((n_samples, shapes.ell)),
                        dtype=torch.float32, device=device)
    rows = {}
    for row, geno, precision in (
        ("packed_q8", lambda: _pack_rows_device(g, packed_cols(n_samples)), "q8"),
        ("dense_q8", lambda: g, "q8"),
        ("dense_bf16", lambda: g, "bf16"),
    ):
        sm = ShardedMatrix(geno(), mean, inv, n_snps, n_samples, device,
                           kernel_precision=precision)
        dt, how = measure(sm, b, shapes.it_lo, shapes.it_hi, device)
        tr = (trace_ms_per_iter(sm, b, shapes.it_lo, row, device)
              if device.type == "cuda" else None)
        rows[row] = (dt, how, tr)
        del sm
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def eigensnp_e2e(shapes: Shapes, device: torch.device, rng) -> dict:
    """The compact EigenSNP run (QC -> two-stage PCA) on a small PLINK
    fileset, cold then warm in this process."""
    from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu_torch.io.bed import write_plink
    from genomic_pca_tpu_torch.models.eigensnp import compute_eigensnp_pca
    from genomic_pca_tpu_torch.models.prepare import prepare_data
    from genomic_pca_tpu_torch.ops import kernels

    d_e2e, n_e2e = shapes.e2e
    with tempfile.TemporaryDirectory(prefix="gptpu_torch_bench_") as td:
        g2 = _host_dosages(rng, d_e2e, n_e2e)
        write_plink(f"{td}/b", g2, bp=list(range(10, d_e2e * 10 + 10, 10)))
        with open(f"{td}/blocks.tsv", "w") as fh:
            edges = np.linspace(0, d_e2e * 10 + 20, 17, dtype=np.int64)
            for i in range(16):
                fh.write(f"1 {edges[i]+1} {edges[i+1]}\n")
        cfg = DataPrepConfig(
            bed_path=f"{td}/b", ld_block_path=f"{td}/blocks.tsv",
            min_maf=0.0, max_hwe_p=1.0,
        )
        ecfg = EigenSnpConfig(k_global=10, min_subset_size=256)

        def run() -> tuple:
            t0 = time.perf_counter()
            prep = prepare_data(cfg, device=device)
            compute_eigensnp_pca(prep, ecfg, device=device)
            _sync(device)
            return prep, time.perf_counter() - t0

        _, cold_dt = run()
        kernels.reset_launch_counts()
        prep, warm_dt = run()
        _log_launches("eigensnp_e2e", _nonzero_launches())
    return {
        "eigensnp_e2e_snps": prep.n_pca_snps,
        "eigensnp_e2e_samples": n_e2e,
        "eigensnp_e2e_cold_seconds": round(cold_dt, 2),
        "eigensnp_e2e_seconds": round(warm_dt, 2),
        "eigensnp_e2e_snps_per_sec": round(prep.n_pca_snps / warm_dt, 1),
    }


def biobank_e2e(shapes: Shapes, device: torch.device) -> dict:
    """The compact biobank run: the generated fileset (cached under the
    temp directory, made again when its size differs), the workflow (the
    three CLI legs on the card, in process on the CPU) and the subset
    oracle.  A failed oracle keeps the run's keys."""
    from genomic_pca_tpu_torch.eval.biobank_bench import (
        ensure_fileset, run_workflow, subset_oracle,
    )

    d_bio, n_bio = shapes.bio
    k = shapes.bio_k
    bio_dir = Path(tempfile.gettempdir()) / f"gptpu_torch_bench_bio_{d_bio}x{n_bio}"
    ensure_fileset(bio_dir, d_bio, n_bio, shapes.bio_blocks, seed=7)
    r = run_workflow(bio_dir, k=k, prefix="bench_run",
                     split=device.type == "cuda", device=device)
    print(f"biobank_e2e container: {r['container']}", file=sys.stderr, flush=True)
    launches = r["launches"]
    for leg, counts in (launches.items() if "legs" in r else [("run", launches)]):
        _log_launches(f"biobank_e2e {leg}", counts)
    bio = {
        "biobank_e2e_snps": d_bio,
        "biobank_e2e_samples": n_bio,
        "biobank_e2e_k": k,
        "biobank_e2e_seconds": r["wall_seconds"],
        "biobank_e2e_legs_seconds": r.get("legs"),
        "biobank_e2e_snps_per_sec": round(d_bio / r["wall_seconds"], 1),
    }
    # The correctness bit: the subset oracle (48 blocks x 4,096 samples in
    # the JAX bench's trade-off between separated PCs and cost).
    try:
        orc = subset_oracle(bio_dir, k=k, n_sub_blocks=shapes.oracle_blocks,
                            n_sub_samples=shapes.oracle_samples, device=device)
    except Exception as e:  # the line keeps the run's numbers; exit 1 follows
        traceback.print_exc()
        bio["biobank_e2e_oracle_error"] = repr(e)
        return bio
    bio["biobank_e2e_per_pc_abs_r_min_separated"] = orc["per_pc_abs_r_min_separated"]
    bio["biobank_e2e_per_pc_abs_r_min_all_k"] = orc["per_pc_abs_r_min"]
    bio["biobank_e2e_oracle"] = {
        k_: orc[k_]
        for k_ in ("subset_snps", "subset_samples", "well_separated_k",
                   "subspace_min_principal_cosine_full_k", "seconds")
    }
    return bio


def baseline_snps_per_sec(rng, n_snps: int, n_samples: int) -> float:
    """The reference oracle's inner loop on this host: numpy float64
    centred Gram accumulation over a sample of strips, best of 3."""
    sample_snps = min(4096, n_snps)
    xs = _host_dosages(rng, sample_snps, n_samples).astype(np.float64)
    xs -= xs.mean(axis=1, keepdims=True)
    base_dt = float("inf")
    for _rep in range(3):
        t0 = time.perf_counter()
        _ = xs.T @ xs
        base_dt = min(base_dt, time.perf_counter() - t0)
    return sample_snps / base_dt


def _guarded(name: str, fn, *args) -> dict:
    """A detail row, or {"<name>_error": ...} when it raised."""
    try:
        return fn(*args)
    except Exception as e:  # the line is printed with the key; exit 1 follows
        traceback.print_exc()
        return {f"{name}_error": repr(e)}


def run(device: torch.device, shapes: Shapes) -> dict:
    """Every row of the bench on `device`; returns the JSON line's dict."""
    on_card = device.type == "cuda"
    n_snps, n_samples, ell = shapes.n_snps, shapes.n_samples, shapes.ell
    rng = np.random.default_rng(0)
    flops_per_iter = 4.0 * n_snps * n_samples * ell  # 2 products x 2 flop/MAC

    loops = power_loop_rows(shapes, device, rng)
    dt_packed, how_packed, tr_packed = loops["packed_q8"]
    dt_dense, how_dense, tr_dense = loops["dense_q8"]
    dt_bf16, how_bf16, tr_bf16 = loops["dense_bf16"]
    marginal_snps_per_sec = n_snps / dt_packed
    if on_card:
        snps_per_sec = n_snps / (tr_packed * 1e-3)
        value_method = "trace_device_time"
    else:
        snps_per_sec = marginal_snps_per_sec
        value_method = f"wall_clock_{how_packed}"

    e2e = _guarded("eigensnp_e2e", eigensnp_e2e, shapes, device, rng)
    bio = _guarded("biobank_e2e", biobank_e2e, shapes, device)
    base_snps_per_sec = baseline_snps_per_sec(rng, n_snps, n_samples)
    platform = f"gpu ({torch.cuda.get_device_name(device)})" if on_card else "cpu"
    cold = ("includes the first call of each EigenSNP shape (plans, solver "
            "handles, allocator growth); the kernel library was loaded by the "
            "power-loop rows")
    return {
        "metric": "packed_q8_power_iteration_throughput",
        "value": round(snps_per_sec, 1),
        "unit": "SNPs/sec",
        # Wall against wall: the marginal dispatch rate over the numpy
        # oracle's wall rate (the headline is device time).
        "vs_baseline": round(marginal_snps_per_sec / base_snps_per_sec, 3),
        "detail": {
            "platform": platform,
            "value_method": value_method,
            "marginal_snps_per_sec": round(marginal_snps_per_sec, 1),
            "n_snps": n_snps,
            "n_samples": n_samples,
            "sketch_width": ell,
            "layout": "PLINK 2-bit packed (production EigenSNP residency), "
                      "q8 power loop (s8 wgmma, kernel 1)",
            "tflops_per_sec_packed_q8": round(flops_per_iter / dt_packed / 1e12, 3),
            "tflops_per_sec_dense_q8": round(flops_per_iter / dt_dense / 1e12, 3),
            "tflops_per_sec_dense_bf16": round(flops_per_iter / dt_bf16 / 1e12, 3),
            "timing_method": {
                "packed_q8": how_packed,
                "dense_q8": how_dense,
                "dense_bf16": how_bf16,
                "eigensnp_e2e_cold": cold,
            },
            "trace_device_ms_per_iter": (
                {
                    "packed_q8": round(tr_packed, 4),
                    "dense_q8": round(tr_dense, 4),
                    "dense_bf16": round(tr_bf16, 4),
                }
                if on_card else {"unavailable": "no device trace under --device cpu"}
            ),
            "trace_tflops_packed_q8": (
                round(flops_per_iter / (tr_packed * 1e-3) / 1e12, 1) if on_card else None
            ),
            "trace_tflops_dense_q8": (
                round(flops_per_iter / (tr_dense * 1e-3) / 1e12, 1) if on_card else None
            ),
            "baseline": "numpy f64 Gram accumulation "
                        "(reference oracle inner loop) on this host",
            "baseline_snps_per_sec": round(base_snps_per_sec, 1),
            **e2e,
            **bio,
        },
    }


def biobank_line(d: int, n: int, k: int, r: dict) -> dict:
    """`--biobank`'s JSON line from `run_workflow`'s result."""
    return {
        "metric": "biobank_eigensnp_e2e_throughput",
        "value": round(d / r["wall_seconds"], 1),
        "unit": "SNPs/sec",
        "vs_baseline": None,
        "detail": {
            "n_snps": d, "n_samples": n, "k": k,
            "wall_seconds": r["wall_seconds"],
            "legs_seconds": r.get("legs"),
            "container": r["container"],
        },
    }


def run_biobank() -> dict:
    """The full-scale biobank configuration (1,048,576 x 102,400, k = 40)
    through the three CLI legs on the card; its fileset is the default one
    of `eval/biobank_bench.py`."""
    from genomic_pca_tpu_torch.eval.biobank_bench import (
        DEFAULT_OUT_DIR, ensure_fileset, run_workflow,
    )

    c = BIOBANK
    ensure_fileset(DEFAULT_OUT_DIR, c["d"], c["n"], c["n_blocks"], c["seed"])
    r = run_workflow(DEFAULT_OUT_DIR, k=c["k"], prefix="bench_run")
    for leg, counts in r["launches"].items():
        _log_launches(f"biobank {leg}", counts)
    return biobank_line(c["d"], c["n"], c["k"], r)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"),
                    help="cpu takes the CPU shapes and wall-clock rates")
    ap.add_argument("--biobank", action="store_true",
                    help="the full-scale biobank run (card only)")
    args = ap.parse_args(argv)
    if args.biobank and args.device == "cpu":
        ap.error("--biobank runs on a card only")
    logging.basicConfig(level=logging.INFO,
                        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
                        datefmt="%H:%M:%S")
    if args.device == "cuda" and not torch.cuda.is_available():
        print("bench: no CUDA device (torch.cuda.is_available() is False); "
              "--device cpu runs the CPU shapes", file=sys.stderr)
        return 1
    if args.biobank:
        line = run_biobank()
    else:
        device = torch.device(args.device)
        line = run(device, CARD if device.type == "cuda" else CPU)
    print(json.dumps(line), flush=True)
    errors = [k for k in line["detail"] if k.endswith("_error")]
    if errors:
        print(f"bench: rows failed: {errors}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

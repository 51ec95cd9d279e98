"""Biobank-scale end-to-end benchmark of the port.

Counterpart of `scripts/biobank_bench.py`: a structured synthetic biobank
fileset (BED -> QC -> EigenSNP PCA at k = 40) run through the port's CLI,
then certified by

  1. a float64 Rayleigh-quotient residual per PC over the full matrix
     (`residual_certificate`), independent of every production kernel,
     and
  2. a sample-subset oracle: the port on a block-aligned SNP subset x a
     random sample keep-list against the exact float64 PCA of the same
     submatrix (`subset_oracle`), per-PC |r|.

The default shape is 1,048,576 SNPs x 102,400 samples (a 26.8 GB BED,
25.6 GB packed after QC).  `generate` writes the same BED, BIM, FAM and
block bytes as the JAX script for the same seed, on its native path and
on its numpy fallback.  `run_workflow` runs the three checkpointed legs
of the JAX script as processes of `python -m genomic_pca_tpu_torch`
(`split=True`), or the workflow in process (`split=False`, the path a
CPU caller takes: the CLI runs only on a card); either way it reports
the container that ran and the kernel launches of each leg.

Progress goes to standard error; `main` prints its summary JSON last on
standard output.  The fileset persists under `--out-dir` (default: a
directory of the port's own under the temp directory) and is made again
only when missing or of another size (`--regen` forces it).

Usage:
  python -m genomic_pca_tpu_torch.eval.biobank_bench                # full
  python -m genomic_pca_tpu_torch.eval.biobank_bench --snps 65536 --samples 102400 \\
      --blocks 64 --residual-backend device
  python -m genomic_pca_tpu_torch.eval.biobank_bench --skip-run --skip-oracle \\
      --residual-backend host                                       # residual only
"""

from __future__ import annotations

import argparse
import json
import logging
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
DEFAULT_OUT_DIR = Path(tempfile.gettempdir()) / "gptpu_torch_biobank"

LAUNCHES_PREFIX = "Kernel launches: "
_CONTAINER = re.compile(r"EigenSNP matrix loaded \((\S+) container, (\S+) mode")


def _say(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def generate(out_dir: Path, d: int, n: int, n_blocks: int, seed: int,
             strip: int = 4096) -> None:
    """Structured synthetic biobank fileset, written strip by strip as
    packed PLINK codes (the model of the JAX script, byte for byte).

    64 populations with geometrically decaying drift; HWE genotypes from
    one uniform byte r: hom-alt if r < 256 p^2, het if < 256 p(2 - p);
    the r == 255 slice (~0.39%) is missing.  MAF in (0.05, 0.5)."""
    n_pops = 64
    rng = np.random.default_rng(seed)
    pop = rng.integers(0, n_pops, n)
    fst_pop = 0.15 * (0.90 ** np.arange(n_pops)) + 0.005
    t0 = time.perf_counter()
    if n % 4:
        raise ValueError("generator requires n_samples % 4 == 0")

    from genomic_pca_tpu_torch.io.native import synth_pack_native

    out_dir.mkdir(parents=True, exist_ok=True)
    with open(out_dir / "biobank.bed", "wb") as fh:
        fh.write(b"\x6c\x1b\x01")
        for lo in range(0, d, strip):
            rows = min(strip, d - lo)
            p_anc = rng.uniform(0.05, 0.95, rows)
            p_pop = np.empty((rows, n_pops), dtype=np.float64)
            for j in range(n_pops):
                fj = fst_pop[j]
                p_pop[:, j] = rng.beta(
                    p_anc * (1 - fj) / fj, (1 - p_anc) * (1 - fj) / fj
                )
            a_pop = np.minimum(p_pop * p_pop * 256.0, 255).astype(np.uint8)
            b_pop = np.minimum(
                p_pop * (2.0 - p_pop) * 256.0, 255
            ).astype(np.uint8)
            # One native pass (PRNG + threshold + 2-bit pack), or numpy
            # with the same model.
            packed = synth_pack_native(
                a_pop, b_pop, pop.astype(np.uint8), seed=seed, row0=lo
            )
            if packed is None:
                a = a_pop[:, pop]
                b = b_pop[:, pop]
                r = rng.integers(0, 256, (rows, n), dtype=np.uint8)
                # PLINK codes (count_A1): 00 = dosage 2 (r < a),
                # 10 = het (a <= r < b), 11 = dosage 0 (r >= b),
                # 01 = missing (r == 255, inside r >= b since b < 256).
                code = (r >= a).astype(np.uint8)
                code <<= 1
                code += r >= b
                code -= (r == 255).astype(np.uint8) << 1
                packed = (
                    code[:, 0::4]
                    | (code[:, 1::4] << 2)
                    | (code[:, 2::4] << 4)
                    | (code[:, 3::4] << 6)
                )
            fh.write(packed.tobytes())
            if lo % (32 * strip) == 0 and lo:
                done = lo / d
                el = time.perf_counter() - t0
                _say(f"  gen {lo}/{d} rows ({100*done:.0f}%, {el:.0f}s "
                     f"elapsed, eta {el/done - el:.0f}s)")

    with open(out_dir / "biobank.bim", "w") as fh:
        chunk = 250_000
        for lo in range(0, d, chunk):
            hi = min(lo + chunk, d)
            fh.write("".join(
                f"1\tsnp{i}\t0\t{10 * i + 10}\tA\tC\n" for i in range(lo, hi)
            ))
    with open(out_dir / "biobank.fam", "w") as fh:
        for lo in range(0, n, 250_000):
            hi = min(lo + 250_000, n)
            fh.write("".join(
                f"sample{i}\tsample{i}\t0\t0\t0\t-9\n" for i in range(lo, hi)
            ))
    edges = np.linspace(0, d * 10 + 20, n_blocks + 1, dtype=np.int64)
    with open(out_dir / "blocks.tsv", "w") as fh:
        for i in range(n_blocks):
            fh.write(f"1 {edges[i] + 1} {edges[i + 1]}\n")
    _say(f"  generated {d}x{n} in {time.perf_counter() - t0:.0f}s "
         f"({(out_dir / 'biobank.bed').stat().st_size / 2**30:.1f} GB)")


def bed_bytes(d: int, n: int) -> int:
    """Size of the generated BED file."""
    return 3 + d * ((n + 3) // 4)


def ensure_fileset(out_dir: Path, d: int, n: int, n_blocks: int, seed: int,
                   regen: bool = False) -> None:
    """Generate the fileset unless a BED of this shape is there."""
    bed = out_dir / "biobank.bed"
    if regen or not bed.exists() or bed.stat().st_size != bed_bytes(d, n):
        _say(f"generating {d}x{n} fileset in {out_dir}...")
        generate(out_dir, d, n, n_blocks, seed)
    else:
        _say(f"fileset present in {out_dir}; skipping generation")


def parse_leg_log(lines: List[str]) -> dict:
    """The container and the kernel launches one workflow run logged:
    {"container": "<container> <mode>" or None, "launches": {name: count}
    of the kernels it launched}."""
    out: dict = {"container": None, "launches": {}}
    for line in lines:
        m = _CONTAINER.search(line)
        if m:
            out["container"] = f"{m.group(1)} {m.group(2)}"
        i = line.find(LAUNCHES_PREFIX)
        if i >= 0:
            counts = json.loads(line[i + len(LAUNCHES_PREFIX):])
            out["launches"] = {k: v for k, v in counts.items() if v}
    return out


class _Capture(logging.Handler):
    def __init__(self):
        super().__init__(logging.INFO)
        self.lines: List[str] = []

    def emit(self, record):
        self.lines.append(record.getMessage())


def run_workflow(out_dir: Path, k: int, prefix: str = "run",
                 split: bool = True, device="cuda") -> dict:
    """BED -> QC -> EigenSNP k workflow with its walls.

    `split=True`: three checkpointed processes of the port's CLI (stage
    1+2 / refinement pass / capture + outputs), one full-matrix pass each,
    as the JAX script composes them; a stale checkpoint directory is
    removed first (its legs would resume and exit at once).  `split=False`:
    `run_eigensnp_workflow` in this process on `device`.  Returns
    `wall_seconds`, the container that ran and the launches (per leg with
    `split`)."""
    # max_hwe_p=1.0 disables the HWE filter: the cohort is structured (64
    # populations), and pooled HWE rejects exactly the differentiated SNPs.
    t0 = time.perf_counter()
    if not split:
        from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
        from genomic_pca_tpu_torch.ops import kernels
        from genomic_pca_tpu_torch.workflows import run_eigensnp_workflow

        cfg = DataPrepConfig(
            bed_path=str(out_dir / "biobank"),
            ld_block_path=str(out_dir / "blocks.tsv"),
            max_hwe_p=1.0,
        )
        ecfg = EigenSnpConfig(k_global=k)
        kernels.reset_launch_counts()
        pkg = logging.getLogger("genomic_pca_tpu_torch")
        handler, level = _Capture(), pkg.level
        pkg.addHandler(handler)
        pkg.setLevel(logging.INFO)
        try:
            run_eigensnp_workflow(cfg, ecfg, str(out_dir / prefix),
                                  write_moments=True, device=device)
        finally:
            pkg.removeHandler(handler)
            pkg.setLevel(level)
        return {"wall_seconds": round(time.perf_counter() - t0, 1),
                **parse_leg_log(handler.lines)}

    import shutil

    ck = out_dir / "ckpt"
    shutil.rmtree(ck, ignore_errors=True)
    base = [
        sys.executable, "-m", "genomic_pca_tpu_torch", "--eigensnp",
        "--bed-file", str(out_dir / "biobank"),
        "--ld-block-file", str(out_dir / "blocks.tsv"),
        "-o", str(out_dir / prefix),
        "--eigensnp-k-global", str(k),
        "--eigensnp-max-hwe-p", "1.0",
        "--eigensnp-checkpoint-dir", str(ck),
        "--write-moments", "--log-level", "Info",
    ]
    legs = [
        ("stages_1_2+global", ["--eigensnp-stop-after-checkpoint",
                               "stage2_basis"]),
        ("refinement_pass", ["--eigensnp-stop-after-checkpoint",
                             "refine_pass_0"]),
        ("capture+outputs", []),
    ]
    leg_walls: Dict[str, float] = {}
    leg_logs: Dict[str, dict] = {}
    for name, extra in legs:
        t1 = time.perf_counter()
        _say(f"  [leg] {name} ...")
        r = subprocess.run(base + extra, cwd=str(REPO), capture_output=True,
                           text=True)
        sys.stderr.write(r.stderr)
        sys.stderr.write(r.stdout)
        if r.returncode != 0:
            raise RuntimeError(f"workflow leg {name!r} failed "
                               f"(exit {r.returncode})")
        leg_walls[name] = round(time.perf_counter() - t1, 1)
        leg_logs[name] = parse_leg_log(r.stderr.splitlines())
        _say(f"  [leg] {name} done in {leg_walls[name]}s")
    containers = {v["container"] for v in leg_logs.values()} - {None}
    return {
        "wall_seconds": round(time.perf_counter() - t0, 1),
        "legs": leg_walls,
        "composition": "3-process checkpointed (one matrix pass per process)",
        "container": " / ".join(sorted(containers)) or None,
        "launches": {name: v["launches"] for name, v in leg_logs.items()},
    }


def _device_strip_gv(pk: torch.Tensor, m: torch.Tensor, iv: torch.Tensor,
                     v: torch.Tensor, n: int) -> torch.Tensor:
    """X^T (X v) of one strip in plain f32 torch from its RAW packed bytes
    (no production kernel, no quantization): a 2-bit unpack by shifts,
    the count_A1 code map 0 -> 2, 1 -> missing, 2 -> 1, 3 -> 0 (a
    missing entry standardizes to exactly 0, mean imputation), then two
    f32 matmuls."""
    codes = torch.stack(
        [(pk >> (2 * p)) & 0b11 for p in range(4)], dim=-1
    ).reshape(pk.shape[0], -1)[:, :n].int()
    code_map = torch.tensor([2.0, 0.0, 1.0, 0.0], device=pk.device)
    code_ok = torch.tensor([1.0, 0.0, 1.0, 1.0], device=pk.device)
    x = (code_map[codes] - m[:, None]) * iv[:, None] * code_ok[codes]
    return x.T @ (x @ v)


def residual_certificate(out_dir: Path, prefix: str = "run",
                         strip: int = 8192, backend: str = "auto",
                         device=None) -> dict:
    """Float64 Rayleigh residual per PC over the FULL matrix.

    Reads the workflow's scores and moments, streams the BED once, and
    computes r_j = ||G v_j - rho_j v_j|| / rho_j for the normalized score
    directions v_j (G = X^T X, never formed; rho_j the Rayleigh
    quotient).  Independent of the production compute path in both
    backends (no hand-written kernel, no q8 quantization, no packed
    container):

    * host   - BED decode + in-place f32 standardize + BLAS GEMM per
               strip, float64 accumulation across strips;
    * device - the same math in plain torch on `device` from the raw
               packed bytes (`_device_strip_gv`), TF32 off, float64
               accumulation on the host;
    * auto   - device when `device` is a card, else host."""
    from genomic_pca_tpu_torch.io.bed import BedReader
    from genomic_pca_tpu_torch.io.writers import read_moments

    t0 = time.perf_counter()
    with open(out_dir / f"{prefix}.eigensnp.pca.tsv") as fh:
        fh.readline()
        scores = np.asarray(
            [ln.rstrip("\n").split("\t")[1:] for ln in fh], dtype=np.float64
        )
    ids, _a1, _a2, means, stds = read_moments(
        str(out_dir / f"{prefix}.eigensnp.moments.tsv"))
    bed = BedReader(str(out_dir / "biobank"))
    pos_of = {sid: i for i, sid in enumerate(bed.bim.sid)}
    rows = np.asarray([pos_of[v] for v in ids], dtype=np.int64)
    inv = np.where(stds > 0, 1.0 / np.where(stds > 0, stds, 1.0), 0.0)
    means32 = means.astype(np.float32)
    inv32 = inv.astype(np.float32)

    if backend == "auto":
        on_card = device is not None and torch.device(device).type == "cuda"
        backend = "device" if on_card else "host"
    if backend not in ("host", "device"):
        raise ValueError(f"unknown residual backend {backend!r}")
    _say(f"  residual backend: {backend}")

    v = scores / np.linalg.norm(scores, axis=0, keepdims=True)  # (N, k)
    v32 = v.astype(np.float32)
    n = scores.shape[0]
    acc = np.zeros_like(v)  # G v, accumulated f64

    if backend == "device":
        dev = torch.device(device if device is not None else "cuda")
        tf32 = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = False
        try:
            v_dev = torch.from_numpy(v32).to(dev)
            m_dev = torch.from_numpy(means32).to(dev)
            iv_dev = torch.from_numpy(inv32).to(dev)
            for lo in range(0, len(rows), strip):
                hi = min(lo + strip, len(rows))
                pk = torch.from_numpy(bed.read_packed(rows[lo:hi])).to(dev)
                part = _device_strip_gv(pk, m_dev[lo:hi], iv_dev[lo:hi],
                                        v_dev, n)
                acc += part.cpu().numpy().astype(np.float64)
                if lo % (8 * strip) == 0:
                    _say(f"  residual pass {lo}/{len(rows)} rows "
                         f"({time.perf_counter() - t0:.0f}s)")
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32
    else:
        for lo in range(0, len(rows), strip):
            hi = min(lo + strip, len(rows))
            g = bed.read(rows[lo:hi])  # (s, N) int8, native decode
            # In-place f32 standardize: centered missing entries are
            # exactly 0 == mean imputation.
            x = g.astype(np.float32)
            np.subtract(x, means32[lo:hi, None], out=x)
            x[g == -127] = 0.0
            np.multiply(x, inv32[lo:hi, None], out=x)
            acc += (x.T @ (x @ v32)).astype(np.float64)
            if lo % (8 * strip) == 0:
                _say(f"  residual pass {lo}/{len(rows)} rows "
                     f"({time.perf_counter() - t0:.0f}s)")
    rho = (v * acc).sum(axis=0)  # Rayleigh quotients
    res = np.linalg.norm(acc - v * rho, axis=0) / rho
    return {
        "backend": backend,
        "residual_per_pc": [float(f"{r:.3e}") for r in res],
        # Unrounded, for comparing the two backends.
        "residual_per_pc_unrounded": [float(r) for r in res],
        "max_residual": float(f"{res.max():.3e}"),
        "rayleigh_eigenvalue_ratio_pc1": float(
            f"{rho[0] / ((n - 1) * _read_eigenvalues(out_dir, prefix)[0]):.6f}"
        ),
        "seconds": round(time.perf_counter() - t0, 1),
    }


def _read_eigenvalues(out_dir: Path, prefix: str) -> np.ndarray:
    with open(out_dir / f"{prefix}.eigenvalues.tsv") as fh:
        fh.readline()
        return np.asarray([ln.split("\t")[1] for ln in fh], dtype=np.float64)


def subset_oracle(out_dir: Path, k: int, n_sub_blocks: int = 128,
                  n_sub_samples: int = 8192, seed: int = 11,
                  device="cuda") -> dict:
    """The port on a block-aligned SNP subset x a random sample keep-list
    against the exact float64 PCA (`models/exact.py`, on `device`) of the
    same submatrix."""
    from genomic_pca_tpu_torch.config import DataPrepConfig, EigenSnpConfig
    from genomic_pca_tpu_torch.io.bed import BedReader
    from genomic_pca_tpu_torch.models.eigensnp import compute_eigensnp_pca
    from genomic_pca_tpu_torch.models.exact import exact_pca_from_strips
    from genomic_pca_tpu_torch.models.prepare import prepare_data

    t0 = time.perf_counter()
    rng = np.random.default_rng(seed)
    bed = BedReader(str(out_dir / "biobank"))
    n_sub_samples = min(n_sub_samples, bed.n_samples)
    keep = np.sort(rng.choice(bed.n_samples, n_sub_samples, replace=False))
    keep_path = out_dir / "oracle_keep.txt"
    with open(keep_path, "w") as fh:
        for i in keep:
            fh.write(f"sample{i}\n")
    blocks = (out_dir / "blocks.tsv").read_text().splitlines()[:n_sub_blocks]
    sub_blocks = out_dir / "oracle_blocks.tsv"
    sub_blocks.write_text("\n".join(blocks) + "\n")

    cfg = DataPrepConfig(
        bed_path=str(out_dir / "biobank"),
        ld_block_path=str(sub_blocks),
        sample_keep_path=str(keep_path),
        max_hwe_p=1.0,  # structured cohort; see run_workflow
    )
    prep = prepare_data(cfg, device=device)
    res = compute_eigensnp_pca(prep, EigenSnpConfig(k_global=k), device=device)

    raw = bed.read(prep.pca_snp_orig_indices, prep.qc_sample_indices)
    exact = exact_pca_from_strips(
        iter([raw]), len(keep), k=k, config=cfg, scale=True, apply_qc=False,
        device=device,
    )
    rr = [
        abs(float(np.corrcoef(res.scores[:, j], exact.scores[:, j])[0, 1]))
        for j in range(k)
    ]
    # Per-PC |r| means something only where the SUBMATRIX spectrum is
    # separated (within a near-degenerate eigenspace both sides return
    # arbitrary bases of one subspace): report it over the prefix before
    # the first relative eigengap under 2%, with the principal cosines
    # over that prefix and over the full k (rotation-invariant).
    ev = np.asarray(exact.eigenvalues, dtype=np.float64)[:k]
    rel_gap = (ev[:-1] - ev[1:]) / np.maximum(ev[:-1], 1e-300)
    sep_k = k
    for j in range(k - 1):
        if rel_gap[j] < 0.02:
            sep_k = j + 1
            break
    qf, _ = np.linalg.qr(np.asarray(res.scores, dtype=np.float64))
    qe, _ = np.linalg.qr(np.asarray(exact.scores, dtype=np.float64))
    cos_sep = np.linalg.svd(
        qf[:, :sep_k].T @ qe[:, :sep_k], compute_uv=False
    )
    cosines = np.linalg.svd(qf.T @ qe, compute_uv=False)
    np.savez(
        out_dir / "oracle_scores.npz",
        framework=np.asarray(res.scores, dtype=np.float32),
        exact=np.asarray(exact.scores, dtype=np.float32),
        exact_eigenvalues=ev,
    )
    return {
        "subset_snps": int(prep.n_pca_snps),
        "subset_samples": int(len(keep)),
        "well_separated_k": int(sep_k),
        "per_pc_abs_r_min_separated": float(f"{min(rr[:sep_k]):.6f}"),
        "subspace_min_principal_cosine_separated": float(
            f"{cos_sep.min():.6f}"
        ),
        "subspace_min_principal_cosine_full_k": float(
            f"{cosines.min():.6f}"
        ),
        "per_pc_abs_r_min": float(f"{min(rr):.6f}"),
        "per_pc_abs_r": [float(f"{r:.5f}") for r in rr],
        "exact_rel_eigengap": [float(f"{g:.4f}") for g in rel_gap],
        "seconds": round(time.perf_counter() - t0, 1),
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="Biobank-scale EigenSNP run of the port with its "
                    "float64 residual certificate and subset oracle.")
    ap.add_argument("--out-dir", default=str(DEFAULT_OUT_DIR))
    ap.add_argument("--snps", type=int, default=1_048_576)
    ap.add_argument("--samples", type=int, default=102_400)
    ap.add_argument("--blocks", type=int, default=1024)
    ap.add_argument("--k", type=int, default=40)
    ap.add_argument("--seed", type=int, default=2025)
    ap.add_argument("--regen", action="store_true")
    ap.add_argument("--generate-only", action="store_true")
    ap.add_argument("--skip-run", action="store_true")
    ap.add_argument("--skip-residual", action="store_true")
    ap.add_argument("--skip-oracle", action="store_true")
    ap.add_argument("--residual-backend", default="auto",
                    choices=("auto", "host", "device"),
                    help="Where the residual certificate's strip math runs "
                         "(both are independent of the production compute "
                         "path; see residual_certificate).")
    args = ap.parse_args(argv)

    logging.basicConfig(
        level=logging.INFO,
        format="[%(asctime)s %(levelname)s %(name)s] %(message)s",
        datefmt="%H:%M:%S",
    )
    out_dir = Path(args.out_dir)
    summary: dict = {
        "config": {
            "snps": args.snps, "samples": args.samples, "k": args.k,
            "ld_blocks": args.blocks,
        }
    }
    # The workflow, the device residual and the oracle run on the card.
    needs_card = not args.generate_only and (
        not args.skip_run or not args.skip_oracle
        or not args.skip_residual and args.residual_backend != "host")
    if needs_card and not torch.cuda.is_available():
        _say("biobank_bench: no CUDA device (torch.cuda.is_available() is "
             "False); only --generate-only and --residual-backend host run "
             "without one")
        return 1
    device = "cuda"
    ensure_fileset(out_dir, args.snps, args.samples, args.blocks, args.seed,
                   regen=args.regen)
    if args.generate_only:
        return 0

    if not args.skip_run:
        _say(f"\n=== full workflow (BED -> QC -> EigenSNP k={args.k}) ===")
        summary["workflow"] = run_workflow(out_dir, args.k)
        summary["workflow"]["snps_per_sec_e2e"] = round(
            args.snps / summary["workflow"]["wall_seconds"], 1
        )

    if not args.skip_residual:
        _say("\n=== float64 Rayleigh residual certificate ===")
        summary["residual"] = residual_certificate(
            out_dir, backend=args.residual_backend, device=device
        )

    if not args.skip_oracle:
        _say("\n=== sample/SNP-subset oracle concordance ===")
        summary["oracle"] = subset_oracle(out_dir, args.k, device=device)

    print(json.dumps(summary, indent=1), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Exact streaming Gram-PCA CLI, the correctness oracle runner, on the port.

Counterpart of `genomic_pca_tpu/eval/exact.py` (the reference's
`tests/pca.py`: streaming QC + exact `eigh`): the same flags plus
`--device {cuda,cpu}`, and the same files, `pca.tsv` (`PC1..PCk
SampleID`) and `py.eigenvalues.tsv` in the output directory, both at
`%.6g`, so the sweep analyzer can inject it as the "Exact PCA Reference"
series.  Strips come from the port's `io/bed.BedReader`; the float64
Gram and `eigh` run on `--device` (`models/exact.py`).  Asked for the
card on a machine without one it exits 1 naming CUDA; it never falls
back to the CPU.

    python -m genomic_pca_tpu_torch.eval.exact --bed-prefix <p> --out-dir <d>
"""

from __future__ import annotations

import argparse
import logging
import time
from pathlib import Path
from typing import List, Optional

from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.io.bed import BedReader

log = logging.getLogger("exact_pca")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="Exact streaming Gram-matrix PCA.")
    p.add_argument("--bed-prefix", required=True)
    p.add_argument("--out-dir", default="pca_results")
    p.add_argument("--k-components", type=int, default=10)
    p.add_argument("--min-call-rate", type=float, default=0.98)
    p.add_argument("--min-maf", type=float, default=0.01)
    p.add_argument("--max-hwe-p", type=float, default=1e-6)
    p.add_argument("--min-variance-epsilon", type=float, default=1e-9)
    p.add_argument("--variant-chunk", type=int, default=2000)
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="Where the float64 Gram and eigh run (default: the card).")
    args = p.parse_args(argv)

    logging.basicConfig(level=logging.INFO, format="%(asctime)s [%(levelname)s] %(message)s")
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        log.error("No CUDA device available: the exact PCA runs on a CUDA GPU "
                  "unless --device cpu is given (torch.cuda.is_available() is "
                  "False).")
        return 1
    from genomic_pca_tpu_torch.models.exact import exact_pca_from_strips

    t0 = time.time()

    reader = BedReader(args.bed_prefix)
    n, d = reader.n_samples, reader.n_snps
    log.info("Samples = %s    Variants = %s", f"{n:,}", f"{d:,}")

    cfg = DataPrepConfig(
        min_call_rate=args.min_call_rate,
        min_maf=args.min_maf,
        max_hwe_p=args.max_hwe_p,
        min_variance=args.min_variance_epsilon,
    )

    def strips():
        for start in range(0, d, args.variant_chunk):
            yield reader.read(
                slice(start, min(start + args.variant_chunk, d)), count_a1=False
            )

    res = exact_pca_from_strips(strips(), n, k=args.k_components, config=cfg,
                                device=args.device)
    load_time = time.time() - t0
    log.info(
        "GRM built from %s variants in %.1f min on %s",
        f"{res.n_kept_variants:,}",
        load_time / 60,
        args.device,
    )

    out_dir = Path(args.out_dir).expanduser().resolve()
    out_dir.mkdir(parents=True, exist_ok=True)
    k = res.scores.shape[1]
    pc_cols = [f"PC{i+1}" for i in range(k)]

    with open(out_dir / "pca.tsv", "w") as fh:
        fh.write("\t".join(pc_cols + ["SampleID"]) + "\n")
        for i in range(n):
            fh.write(
                "\t".join(f"{v:.6g}" for v in res.scores[i])
                + f"\t{reader.fam.iid[i]}\n"
            )
    with open(out_dir / "py.eigenvalues.tsv", "w") as fh:
        fh.write("PC\tEigenvalue\n")
        for name, ev in zip(pc_cols, res.eigenvalues):
            fh.write(f"{name}\t{ev:.6g}\n")

    log.info("Total wall-time %.1fs; results in %s", time.time() - t0, out_dir)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

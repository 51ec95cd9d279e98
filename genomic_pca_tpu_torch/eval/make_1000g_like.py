"""Generate a labeled 1000G-chr22-like synthetic dataset.

The reference's eval harness runs on real 1000 Genomes chr22 with IGSR
population labels (the reference's tests/metrics.py:3,
tests/README.md:1-3); those blobs are absent from the snapshot, so this
produces a statistically similar stand-in: a hierarchical
Balding-Nichols genotype model with the 26 1000G subpopulations nested
in their 5 superpopulations, array-scale chr22 SNP counts, missing
calls, an IGSR-schema sample label file, and an LD-block file.

Outputs under --out-dir:
  chr22.bed/.bim/.fam    PLINK fileset (n_snps x n_samples)
  igsr_samples.tsv       'Sample name' / 'Population code' /
                         'Superpopulation code' (metrics.py schema)
  blocks.tsv             whitespace `chr start end` LD blocks

The port's copy of `scripts/make_1000g_like.py`, writing through the
port's own `io/bed.write_plink` (the original imports the JAX package's),
so that a machine without jax can make the cohort; the files are byte
for byte the original's.

Usage: python -m genomic_pca_tpu_torch.eval.make_1000g_like \
           --out-dir <dir> [--snps 60000] [--samples 2504] [--blocks 120] \
           [--seed 2025]
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np

# 1000G phase-3 populations: superpop -> subpops (sizes roughly match
# the real cohort's ~2504-sample composition).
POPULATIONS = {
    "AFR": ["YRI", "LWK", "GWD", "MSL", "ESN", "ASW", "ACB"],
    "AMR": ["MXL", "PUR", "CLM", "PEL"],
    "EAS": ["CHB", "JPT", "CHS", "CDX", "KHV"],
    "EUR": ["CEU", "TSI", "FIN", "GBR", "IBS"],
    "SAS": ["GIH", "PJL", "BEB", "STU", "ITU"],
}
FST_SUPER = 0.09  # differentiation of superpops from the ancestral pool
FST_SUB = 0.012  # differentiation of subpops within a superpop


def make_dataset(
    out_dir: str,
    n_snps: int = 60_000,
    n_samples: int = 2504,
    n_blocks: int = 120,
    seed: int = 2025,
    missing_rate: float = 0.005,
):
    from genomic_pca_tpu_torch.io.bed import write_plink

    rng = np.random.default_rng(seed)
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)

    subpops = [(sp, p) for sp, ps in POPULATIONS.items() for p in ps]
    # Distribute samples over the 26 subpops (roughly even, like 1000G).
    per = np.full(len(subpops), n_samples // len(subpops))
    per[: n_samples - int(per.sum())] += 1

    labels = []
    for (sp, p), cnt in zip(subpops, per):
        labels.extend([(sp, p)] * int(cnt))
    sample_ids = [f"SYN{i:05d}" for i in range(n_samples)]

    # Hierarchical Balding-Nichols allele frequencies.
    ancestral = rng.uniform(0.05, 0.95, size=n_snps)

    def bn(p, fst):
        a = p * (1 - fst) / fst
        b = (1 - p) * (1 - fst) / fst
        return rng.beta(np.maximum(a, 1e-3), np.maximum(b, 1e-3))

    sub_freq = {}
    for sp in POPULATIONS:
        super_p = bn(ancestral, FST_SUPER)
        for p in POPULATIONS[sp]:
            sub_freq[p] = bn(super_p, FST_SUB)

    geno = np.empty((n_snps, n_samples), dtype=np.int8)
    col = 0
    for (sp, p), cnt in zip(subpops, per):
        cnt = int(cnt)
        f = sub_freq[p][:, None]
        geno[:, col : col + cnt] = rng.binomial(2, f, size=(n_snps, cnt))
        col += cnt
    if missing_rate > 0:
        mask = rng.random(geno.shape) < missing_rate
        geno = np.where(mask, np.int8(-127), geno)

    # chr22-like coordinates: ~35 Mb of spacing.
    bp = np.sort(rng.choice(35_000_000, size=n_snps, replace=False)) + 16_000_000
    write_plink(
        str(out / "chr22"), geno,
        chrom=["22"] * n_snps, bp=[int(x) for x in bp], iid=sample_ids,
    )

    with open(out / "igsr_samples.tsv", "w") as fh:
        fh.write("Sample name\tSex\tPopulation code\tSuperpopulation code\n")
        for sid, (sp, p) in zip(sample_ids, labels):
            fh.write(f"{sid}\tunknown\t{p}\t{sp}\n")

    edges = np.linspace(bp[0] - 1, bp[-1] + 1, n_blocks + 1, dtype=np.int64)
    with open(out / "blocks.tsv", "w") as fh:
        for i in range(n_blocks):
            fh.write(f"22 {edges[i] + 1} {edges[i + 1]}\n")

    return str(out / "chr22"), str(out / "igsr_samples.tsv"), str(out / "blocks.tsv")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--out-dir", required=True)
    ap.add_argument("--snps", type=int, default=60_000)
    ap.add_argument("--samples", type=int, default=2504)
    ap.add_argument("--blocks", type=int, default=120)
    ap.add_argument("--seed", type=int, default=2025)
    args = ap.parse_args()
    bed, samples, blocks = make_dataset(
        args.out_dir, args.snps, args.samples, args.blocks, args.seed
    )
    print(f"bed={bed}\nsamples={samples}\nblocks={blocks}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

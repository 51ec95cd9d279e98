"""PLINK BED access-pattern microbenchmark.

A copy of `genomic_pca_tpu/eval/diskbench.py` (the reference's
tests/disk.py) over the port's `io/bed.BedReader`, with the same JSON
keys: measures genotypes/sec for
the access patterns the EigenSNP pipeline depends on —

  1. sequential fixed-size SNP strips (QC streaming),
  2. random LD-block reads (50-200 SNPs, stage-1 local bases),
  3. sample-subset reads (local basis learning subsets),
  4. thread-parallel block reads (prefetch pipeline feed).

Runs against any local .bed fileset; each test runs under a time cap
(the reference uses 28 s, disk.py:22-28).
"""

from __future__ import annotations

import argparse
import json
import time
from concurrent.futures import ThreadPoolExecutor
from typing import List, Optional

import numpy as np

from genomic_pca_tpu_torch.io.bed import BedReader


def _rate(genotypes: int, seconds: float) -> float:
    return genotypes / max(seconds, 1e-9)


def test_sequential_strips(reader: BedReader, strip: int, cap_s: float) -> float:
    t0 = time.perf_counter()
    done = 0
    for start in range(0, reader.n_snps, strip):
        g = reader.read(slice(start, min(start + strip, reader.n_snps)))
        done += g.size
        if time.perf_counter() - t0 > cap_s:
            break
    return _rate(done, time.perf_counter() - t0)


def test_random_blocks(reader: BedReader, cap_s: float, seed: int = 0) -> float:
    rng = np.random.default_rng(seed)
    t0 = time.perf_counter()
    done = 0
    while time.perf_counter() - t0 < cap_s:
        size = int(rng.integers(50, 201))
        start = int(rng.integers(0, max(reader.n_snps - size, 1)))
        g = reader.read(np.arange(start, start + size))
        done += g.size
        if done > 5e9:
            break
    return _rate(done, time.perf_counter() - t0)


def test_sample_subset(reader: BedReader, strip: int, cap_s: float, seed: int = 0) -> float:
    rng = np.random.default_rng(seed)
    subset = np.sort(
        rng.permutation(reader.n_samples)[: max(reader.n_samples // 10, 1)]
    )
    t0 = time.perf_counter()
    done = 0
    for start in range(0, reader.n_snps, strip):
        g = reader.read(slice(start, min(start + strip, reader.n_snps)), subset)
        done += g.size
        if time.perf_counter() - t0 > cap_s:
            break
    return _rate(done, time.perf_counter() - t0)


def test_parallel_blocks(
    reader: BedReader, cap_s: float, n_workers: int = 4, seed: int = 0
) -> float:
    rng = np.random.default_rng(seed)
    blocks: List[np.ndarray] = []
    for _ in range(256):
        size = int(rng.integers(50, 201))
        start = int(rng.integers(0, max(reader.n_snps - size, 1)))
        blocks.append(np.arange(start, start + size))
    t0 = time.perf_counter()
    done = 0
    with ThreadPoolExecutor(n_workers) as pool:
        for g in pool.map(reader.read, blocks):
            done += g.size
            if time.perf_counter() - t0 > cap_s:
                break
    return _rate(done, time.perf_counter() - t0)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description="BED access-pattern benchmark.")
    p.add_argument("--bed-prefix", required=True)
    p.add_argument("--strip-size", type=int, default=2000)
    p.add_argument("--time-cap", type=float, default=28.0)
    p.add_argument("--workers", type=int, default=4)
    args = p.parse_args(argv)

    reader = BedReader(args.bed_prefix)
    results = {
        "sequential_strips_genotypes_per_sec": test_sequential_strips(
            reader, args.strip_size, args.time_cap
        ),
        "random_ld_blocks_genotypes_per_sec": test_random_blocks(
            reader, args.time_cap
        ),
        "sample_subset_genotypes_per_sec": test_sample_subset(
            reader, args.strip_size, args.time_cap
        ),
        "parallel_blocks_genotypes_per_sec": test_parallel_blocks(
            reader, args.time_cap, args.workers
        ),
    }
    print(json.dumps({k: round(v, 1) for k, v in results.items()}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

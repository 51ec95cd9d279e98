"""TSV output writers, byte-compatible with the reference.

Formats from reference src/main.rs:682-840:

* `{prefix}.vcf.pca.tsv` / `{prefix}.eigensnp.pca.tsv` —
  header `SampleID\tPC1...`, values `%.6f` fixed-point.
* `{prefix}.eigenvalues.tsv` — header `PC\tEigenvalue`, rows `{i}\t%.6f`;
  header written even when there are no eigenvalues (main.rs:771-776).
* `{prefix}.eigensnp.loadings.tsv` — header
  `VariantID\tChrom\tPos\tPC{i}_loading...`; row-count consistency check
  (main.rs:817-824).

Parent directories are created like the reference does
(main.rs:219-225, 372-378).

A copy of `genomic_pca_tpu/io/writers.py`: the port keeps its own copy so that it
imports nothing of the JAX package; tests/test_torch_copies.py pins
it to the original.
"""

from __future__ import annotations

import logging
import os
from typing import Sequence

import numpy as np

log = logging.getLogger(__name__)


def _open_out(prefix: str, suffix: str):
    path = f"{prefix}.{suffix}"
    parent = os.path.dirname(path)
    if parent:
        os.makedirs(parent, exist_ok=True)
    return open(path, "w", buffering=1 << 20)


def _write_body_fast(fh, lead_cols, values, chunk: int = 16384) -> None:
    """Append rows `lead0\t...\tleadN\t%.6f\t...%.6f\n` with ONE
    C-level printf per chunk of rows: the lead strings are baked into a
    per-chunk format string (with '%' escaped) and the float block
    formats in a single `fmt % tuple(...)` call.  Identical bytes to
    the per-value Python loop (printf %.6f both ways), ~30x faster —
    biobank-scale outputs (1M x 40 loadings) format 40M+ floats, where
    the per-value loop takes minutes.
    """
    vals = np.asarray(values, dtype=np.float64)
    n_rows, n_cols = vals.shape
    body = "\t%.6f" * n_cols + "\n"
    leads = [
        "\t".join(str(c[i]) for c in lead_cols).replace("%", "%%")
        for i in range(n_rows)
    ]
    for lo in range(0, n_rows, chunk):
        hi = min(lo + chunk, n_rows)
        fmt = body.join(leads[lo:hi]) + body
        fh.write(fmt % tuple(vals[lo:hi].ravel().tolist()))


def write_principal_components(
    prefix: str,
    sample_names: Sequence[str],
    scores: np.ndarray,
    suffix: str = "eigensnp.pca.tsv",
) -> None:
    """Write sample x PC scores. Use suffix "vcf.pca.tsv" for the VCF mode."""
    scores = np.asarray(scores)
    if scores.ndim != 2 or scores.shape[1] == 0:
        log.info("No principal components (sample scores) to write.")
        return
    n_rows, n_pcs = scores.shape
    with _open_out(prefix, suffix) as fh:
        fh.write("SampleID")
        for i in range(1, n_pcs + 1):
            fh.write(f"\tPC{i}")
        fh.write("\n")
        if len(sample_names) == n_rows:
            _write_body_fast(
                fh, [[str(s) for s in sample_names]], scores
            )
            return
        for s_idx, name in enumerate(sample_names):
            fh.write(str(name))
            if s_idx < n_rows:
                row = scores[s_idx]
                fh.write("".join(f"\t{v:.6f}" for v in row))
            else:
                log.warning(
                    "Sample index %d out of bounds for PCs (%d rows); writing NA.",
                    s_idx,
                    n_rows,
                )
                fh.write("\tNA" * n_pcs)
            fh.write("\n")


def write_eigenvalues(prefix: str, eigenvalues: Sequence[float]) -> None:
    with _open_out(prefix, "eigenvalues.tsv") as fh:
        fh.write("PC\tEigenvalue\n")
        for i, ev in enumerate(np.asarray(eigenvalues, dtype=np.float64), start=1):
            fh.write(f"{i}\t{ev:.6f}\n")


def write_loadings(
    prefix: str,
    variant_ids: Sequence[str],
    chromosomes: Sequence[str],
    positions: Sequence[int],
    loadings: np.ndarray,
) -> None:
    loadings = np.asarray(loadings)
    if loadings.ndim != 2 or loadings.shape[1] == 0:
        log.info("No SNP loadings to write (0 components).")
        return
    n_pcs = loadings.shape[1]
    with _open_out(prefix, "eigensnp.loadings.tsv") as fh:
        fh.write("VariantID\tChrom\tPos")
        for i in range(1, n_pcs + 1):
            fh.write(f"\tPC{i}_loading")
        fh.write("\n")
        if len(variant_ids) == 0:
            return
        if not (
            len(variant_ids) == len(chromosomes) == len(positions) == loadings.shape[0]
        ):
            raise ValueError(
                "Mismatch in lengths of variant metadata and loadings rows: "
                f"ids={len(variant_ids)} chroms={len(chromosomes)} "
                f"pos={len(positions)} rows={loadings.shape[0]}"
            )
        _write_body_fast(
            fh,
            [
                [str(v) for v in variant_ids],
                [str(c) for c in chromosomes],
                [int(p) for p in positions],
            ],
            loadings,
        )


def write_moments(
    prefix: str,
    variant_ids: Sequence[str],
    means: np.ndarray,
    stds: np.ndarray,
    a1: Sequence[str],
    a2: Sequence[str],
) -> None:
    """Write per-SNP training standardization moments + allele
    orientation (`{prefix}.eigensnp.moments.tsv`).

    Extension over the reference (its PCA model holds the moments
    in-memory only, so `transform` cannot outlive the process —
    DEVIATIONS.md §8): this artifact plus the loadings TSV make the
    fitted model re-loadable for `--project`.  A1/A2 pin the dosage
    orientation: a new fileset with swapped alleles encodes
    dosage' = 2 - dosage, and projecting through it unchecked would
    silently flip that SNP's contribution.  Full precision (%.9g) —
    these feed new-sample standardization, not human eyes.
    """
    means = np.asarray(means, dtype=np.float64)
    stds = np.asarray(stds, dtype=np.float64)
    if not (
        len(variant_ids) == len(means) == len(stds) == len(a1) == len(a2)
    ):
        raise ValueError(
            f"Mismatch: ids={len(variant_ids)} means={len(means)} "
            f"stds={len(stds)} a1={len(a1)} a2={len(a2)}"
        )
    with _open_out(prefix, "eigensnp.moments.tsv") as fh:
        fh.write("VariantID\tA1\tA2\tMean\tStd\n")
        for i, vid in enumerate(variant_ids):
            fh.write(
                f"{vid}\t{a1[i]}\t{a2[i]}\t{means[i]:.9g}\t{stds[i]:.9g}\n"
            )


def read_moments(path: str):
    """Read a moments TSV ->
    (variant_ids, a1, a2, means f64, stds f64)."""
    ids, a1s, a2s, means, stds = [], [], [], [], []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        if header != ["VariantID", "A1", "A2", "Mean", "Std"]:
            raise ValueError(f"Not a moments TSV: {path} (header {header})")
        for line in fh:
            vid, a1, a2, m, s = line.rstrip("\n").split("\t")
            ids.append(vid)
            a1s.append(a1)
            a2s.append(a2)
            means.append(float(m))
            stds.append(float(s))
    return ids, a1s, a2s, np.asarray(means), np.asarray(stds)


def read_loadings(path: str):
    """Read a `{prefix}.eigensnp.loadings.tsv` ->
    (variant_ids list, loadings (D, K) f64)."""
    ids, rows = [], []
    with open(path) as fh:
        header = fh.readline().rstrip("\n").split("\t")
        if header[:3] != ["VariantID", "Chrom", "Pos"] or not all(
            h.startswith("PC") for h in header[3:]
        ):
            raise ValueError(f"Not a loadings TSV: {path} (header {header})")
        k = len(header) - 3
        for line in fh:
            parts = line.rstrip("\n").split("\t")
            ids.append(parts[0])
            rows.append([float(x) for x in parts[3:]])
    return ids, np.asarray(rows, dtype=np.float64).reshape(len(ids), k)

"""LD-block definition file parsing and SNP -> block mapping.

Semantics match the reference exactly
(reference src/prepare.rs:1424-1616):

* File format: whitespace-separated `chr start end` (>=3 fields); lines
  that are empty, start with `#`, `chr\t`, or `chromosome\t` are skipped;
  malformed (<3 fields) lines are warned and skipped; unparsable
  coordinates are errors.
* Chromosome names are normalized by lowercasing and stripping a leading
  "chr" (prepare.rs:1610-1616).
* Block IDs are auto-generated as `chr:start-end` (prepare.rs:1597).
* Each QC'd SNP maps to the FIRST block (in file order) containing it,
  inclusive on both ends (prepare.rs:1447-1463).
* The PCA SNP index space is the sorted set of blocked SNPs (dense
  re-index by original BIM order, prepare.rs:1465-1486); per-block SNP
  lists are sorted and blocks are ordered by tag (prepare.rs:1526-1549).

A copy of `genomic_pca_tpu/io/ldblocks.py`: the port keeps its own copy so that it
imports nothing of the JAX package; tests/test_torch_copies.py pins
it to the original.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Dict, List, Sequence, Tuple

import numpy as np

log = logging.getLogger(__name__)


@dataclasses.dataclass
class LdBlockSpec:
    """Equivalent of `LdBlockSpecification` (prepare.rs:1540-1543)."""

    tag: str
    pca_snp_ids: np.ndarray  # sorted dense PCA SNP ids in this block


def normalize_chromosome_name(name: str) -> str:
    name = name.lower()
    if name.startswith("chr"):
        name = name[3:]
    return name


def _factorize_strings(arr: np.ndarray):
    """(codes int64, uniques list) in first-appearance order, O(n) hash."""
    try:
        import pandas as pd

        codes, uniques = pd.factorize(arr)
        return np.asarray(codes, dtype=np.int64), list(uniques)
    except ImportError:  # pragma: no cover - pandas is in the image
        table: Dict[str, int] = {}
        codes = np.empty(len(arr), dtype=np.int64)
        for i, v in enumerate(arr):
            codes[i] = table.setdefault(v, len(table))
        uniq = [None] * len(table)
        for v, k in table.items():
            uniq[k] = v
        return codes, uniq


def parse_ld_block_file(path: str) -> List[Tuple[str, int, int, str]]:
    """Returns [(normalized_chr, start, end, auto_tag)] in file order."""
    blocks: List[Tuple[str, int, int, str]] = []
    with open(path, "r") as fh:
        for line_num, line in enumerate(fh, start=1):
            trimmed = line.strip()
            if (
                not trimmed
                or trimmed.startswith("#")
                or trimmed.startswith("chr\t")
                or trimmed.startswith("chromosome\t")
            ):
                continue
            parts = trimmed.split()
            if len(parts) < 3:
                log.warning(
                    "Skipping malformed LD block line %d: %r "
                    "(expected at least 3 fields: chr start end)",
                    line_num,
                    line,
                )
                continue
            chrom = normalize_chromosome_name(parts[0])
            try:
                start = int(parts[1])
                end = int(parts[2])
            except ValueError as e:
                raise ValueError(
                    f"LD block line {line_num}: error parsing coordinates: {e}"
                ) from e
            blocks.append((chrom, start, end, f"{chrom}:{start}-{end}"))
    if not blocks:
        log.warning("No valid LD blocks parsed from file: %s", path)
    else:
        log.info("Parsed %d LD blocks (IDs auto-generated).", len(blocks))
    return blocks


def assign_first_containing_block(
    snp_chroms: Sequence[str],
    snp_positions: Sequence[int],
    parsed_blocks: List[Tuple[str, int, int, str]],
) -> np.ndarray:
    """Per-SNP index of the FIRST (file-order) block containing it, -1 if
    none — the reference's assignment rule (prepare.rs:1447-1463),
    vectorized: per chromosome, walk blocks in file order and claim
    still-unassigned SNPs whose position falls inside (inclusive)."""
    positions = np.asarray(snp_positions, dtype=np.int64)
    # Normalize per UNIQUE chromosome name (a handful) instead of per
    # SNP — the per-SNP Python loop cost ~6 s at 4.35M rows.  Hash-based
    # factorization: np.unique would SORT millions of strings.
    raw_chroms = np.asarray(snp_chroms, dtype=object)
    inv, uniq = _factorize_strings(raw_chroms)
    uniq_norm = [normalize_chromosome_name(str(u)) for u in uniq]
    n = len(positions)
    assignment = np.full(n, -1, dtype=np.int64)  # index into parsed_blocks

    snp_idx_by_chrom: Dict[str, np.ndarray] = {}
    for k, chrom in enumerate(uniq_norm):
        idx_k = np.nonzero(inv == k)[0]
        prev = snp_idx_by_chrom.get(chrom)
        # distinct raw spellings can normalize to one chromosome
        snp_idx_by_chrom[chrom] = (
            idx_k if prev is None else np.sort(np.concatenate([prev, idx_k]))
        )

    blocks_by_chrom: Dict[str, List[int]] = {}
    for b_idx, (chrom, _s, _e, _t) in enumerate(parsed_blocks):
        blocks_by_chrom.setdefault(chrom, []).append(b_idx)

    for chrom, b_idxs in blocks_by_chrom.items():
        idx = snp_idx_by_chrom.get(chrom)
        if idx is None or len(idx) == 0:
            continue
        pos = positions[idx]
        starts = np.array([parsed_blocks[b][1] for b in b_idxs], dtype=np.int64)
        ends = np.array([parsed_blocks[b][2] for b in b_idxs], dtype=np.int64)
        order = np.argsort(starts, kind="stable")
        s_sorted, e_sorted = starts[order], ends[order]
        # Fast path: non-overlapping intervals (the common case for LD
        # block files) — at most one block contains any position, so
        # "first containing" is "the containing one" and a searchsorted
        # resolves all SNPs of the chromosome at once.  The per-block
        # mask walk is O(blocks x SNPs) and took ~90 s at 10M SNPs x
        # 1,400 blocks; this is O(SNPs log blocks).
        if len(s_sorted) > 1 and np.all(e_sorted[:-1] < s_sorted[1:]):
            at = np.searchsorted(s_sorted, pos, side="right") - 1
            at_c = np.clip(at, 0, len(s_sorted) - 1)
            hit = (at >= 0) & (pos <= e_sorted[at_c])
            assignment[idx[hit]] = np.asarray(b_idxs, dtype=np.int64)[
                order[at_c[hit]]
            ]
            continue
        for b in b_idxs:  # overlap-tolerant reference semantics
            _c, start, end, _tag = parsed_blocks[b]
            hit = (assignment[idx] < 0) & (pos >= start) & (pos <= end)
            assignment[idx[hit]] = b
    return assignment


def block_aligned_ranges(
    snp_chroms: Sequence[str],
    snp_positions: Sequence[int],
    parsed_blocks: List[Tuple[str, int, int, str]],
    n_parts: int,
) -> List[Tuple[int, int]]:
    """Split BIM rows [0, n) into n_parts contiguous scan ranges whose
    boundaries never bisect an LD block.

    Used by the distributed QC scan so each process's QC survivors form
    a contiguous PcaSnpId run whose LD blocks are wholly process-local —
    LD-block locality as the shard-boundary heuristic (SURVEY §2.3).  A
    split at row s is valid when rows s-1 and s are not in the same
    block; each even-split target moves to the nearest valid row.  Falls
    back to plain even splits if a degenerate block file leaves no valid
    boundary (callers must tolerate blocks spanning ranges).
    """
    n = len(snp_positions)
    if n_parts <= 1 or n == 0:
        return [(0, n)] + [(n, n)] * (n_parts - 1)
    assignment = assign_first_containing_block(
        snp_chroms, snp_positions, parsed_blocks
    )
    # valid[s] for s in 1..n-1: rows s-1, s not in one block.
    same = (assignment[:-1] == assignment[1:]) & (assignment[:-1] >= 0)
    valid = np.nonzero(~same)[0] + 1  # ascending split candidates
    cuts = [0]
    for p in range(1, n_parts):
        target = (p * n) // n_parts
        if len(valid) == 0:
            cuts.append(target)
            continue
        pos = np.searchsorted(valid, target)
        cands = [
            c
            for c in (
                valid[pos - 1] if pos > 0 else None,
                valid[pos] if pos < len(valid) else None,
            )
            if c is not None
        ]
        best = min(cands, key=lambda c: abs(int(c) - target))
        cuts.append(max(int(best), cuts[-1]))
    cuts.append(n)
    return [(cuts[i], max(cuts[i + 1], cuts[i])) for i in range(n_parts)]


def map_snps_to_blocks(
    snp_chroms: Sequence[str],
    snp_positions: Sequence[int],
    snp_original_indices: Sequence[int],
    parsed_blocks: List[Tuple[str, int, int, str]],
) -> Tuple[List[LdBlockSpec], np.ndarray]:
    """Map QC'd SNPs to LD blocks; returns (blocks, pca_snp_original_indices).

    The returned original-index array defines the dense PcaSnpId space
    (position i <-> PcaSnpId i); blocks reference that space and come
    sorted by tag.  SNPs contained in no block are excluded from PCA.
    """
    orig_arr = np.asarray(snp_original_indices, dtype=np.int64)
    n = len(orig_arr)
    assignment = assign_first_containing_block(
        snp_chroms, snp_positions, parsed_blocks
    )

    masked_idx = np.nonzero(assignment >= 0)[0]
    if len(masked_idx) == 0:
        log.warning("No SNPs mapped to any LD blocks after filtering.")
        return [], np.zeros(0, dtype=np.int64)

    # PcaSnpId space = blocked originals sorted ascending (callers pass
    # ascending BIM order, making this a no-op sort, but the contract
    # does not require it).
    masked_orig = orig_arr[masked_idx]
    order = np.argsort(masked_orig, kind="stable")
    pca_orig = masked_orig[order]
    pca_id_of_input = np.full(n, -1, dtype=np.int64)
    pca_id_of_input[masked_idx[order]] = np.arange(len(order), dtype=np.int64)

    # Group SNPs by assigned block via one sort instead of one
    # full-array equality scan per block (O(blocks x SNPs) cost ~6 s at
    # 4.35M SNPs x 1,361 blocks).
    a_masked = assignment[masked_idx]
    grp = np.argsort(a_masked, kind="stable")
    a_sorted = a_masked[grp]
    ids_sorted = pca_id_of_input[masked_idx[grp]]
    uniq_b, starts_b = np.unique(a_sorted, return_index=True)
    bounds = np.append(starts_b, len(a_sorted))
    tag_to_ids: Dict[str, List[np.ndarray]] = {}
    for k, b_idx in enumerate(uniq_b):
        tag = parsed_blocks[int(b_idx)][3]
        tag_to_ids.setdefault(tag, []).append(
            ids_sorted[bounds[k] : bounds[k + 1]]
        )

    specs = [
        LdBlockSpec(
            tag=tag,
            pca_snp_ids=np.sort(np.concatenate(parts)).astype(np.int64),
        )
        for tag, parts in tag_to_ids.items()
    ]
    specs.sort(key=lambda s: s.tag)
    return specs, pca_orig

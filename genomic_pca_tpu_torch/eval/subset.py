"""Merge variant TSVs into a unique, genomically sorted (chrom, pos) list.

A copy of `genomic_pca_tpu/eval/subset.py` (the reference's
data/subset.py), kept in the port so it imports nothing of the JAX
package: combines any number of
tab-separated files whose first two columns are chromosome and position
into one deduplicated list sorted by genomic chromosome order
(1-22, X, Y, MT, XY — subset.py:20-38) then position.
"""

from __future__ import annotations

import argparse
from typing import List, Optional, Tuple

_CHROM_ORDER = {str(i): i for i in range(1, 23)}
_CHROM_ORDER.update({"X": 23, "Y": 24, "MT": 25, "M": 25, "XY": 26})


def chrom_sort_key(chrom: str) -> Tuple[int, str]:
    c = chrom.upper()
    if c.startswith("CHR"):
        c = c[3:]
    return (_CHROM_ORDER.get(c, 99), c)


def create_combined_subset_tsv(
    input_paths: List[str], output_path: str
) -> int:
    """Merge, dedupe, sort; returns the number of unique sites written."""
    seen = set()
    rows: List[Tuple[str, int]] = []
    for path in input_paths:
        with open(path) as fh:
            for line in fh:
                line = line.strip()
                if not line or line.startswith("#"):
                    continue
                parts = line.split("\t") if "\t" in line else line.split()
                if len(parts) < 2:
                    continue
                chrom = parts[0]
                try:
                    pos = int(parts[1])
                except ValueError:
                    continue  # header row
                key = (chrom, pos)
                if key not in seen:
                    seen.add(key)
                    rows.append(key)
    rows.sort(key=lambda r: (chrom_sort_key(r[0]), r[1]))
    with open(output_path, "w") as fh:
        for chrom, pos in rows:
            fh.write(f"{chrom}\t{pos}\n")
    return len(rows)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(
        description="Combine variant TSVs into a unique sorted site list."
    )
    p.add_argument("inputs", nargs="+")
    p.add_argument("-o", "--output", required=True)
    args = p.parse_args(argv)
    n = create_combined_subset_tsv(args.inputs, args.output)
    print(f"Wrote {n} unique sites to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""PLINK .bed/.bim/.fam reader (and writer, for tests/synthetic data).

TPU-native replacement for the reference's `bed-reader` dependency
(reference src/prepare.rs:21, 622-629): memory-mapped 2-bit decode of
the SNP-major PLINK1 .bed format into int8 dosage arrays with the -127
missing sentinel the rest of the framework standardizes on
(prepare.rs:1224, 1269).

Decoding strategy: a 256x4 lookup table turns each packed byte into four
int8 dosages in one vectorized gather — the whole unpack is a single numpy
fancy-index over the mmap'd byte block, which saturates memory bandwidth
without needing native code.  A C++ decoder (native/plinkio.cpp) is used
instead when built, for multi-threaded decode of biobank-scale strips.

Genotype bit codes (PLINK1): 00=hom A1, 01=missing, 10=het, 11=hom A2.
`count_a1=True` (the reference EigenSNP path, prepare.rs:627) counts the A1
allele: 00->2, 10->1, 11->0.  `count_a1=False` (the reference oracle,
tests/pca.py:74) counts A2: 00->0, 10->1, 11->2.

The .bim and .fam tables are parsed in one native pass
(`native.parse_table_native`) when the library loads; the line loops
`_bim_loop` / `_fam_loop` parse what it hands over, or all of it without
the library, and define the values and the errors.

A copy of `genomic_pca_tpu/io/bed.py`, but for that parse: the port keeps
its own copy so that it imports nothing of the JAX package;
tests/test_torch_copies.py pins it to the original, and
tests/test_torch_plink_tables.py the tables to its readers.
"""

from __future__ import annotations

import dataclasses
import logging
from pathlib import Path
from typing import Optional, Sequence, Union

import numpy as np

from genomic_pca_tpu_torch.errors import BedFormatError
from genomic_pca_tpu_torch.io import native
from genomic_pca_tpu_torch.utils.profiling import COUNTS

log = logging.getLogger(__name__)

MISSING = np.int8(-127)
_MAGIC = bytes([0x6C, 0x1B, 0x01])  # PLINK1 SNP-major magic


def _build_lut(count_a1: bool) -> np.ndarray:
    """256x4 int8 LUT: byte value -> 4 decoded genotypes (low bits first)."""
    if count_a1:
        code_map = np.array([2, -127, 1, 0], dtype=np.int8)
    else:
        code_map = np.array([0, -127, 1, 2], dtype=np.int8)
    byte_vals = np.arange(256, dtype=np.uint16)
    lut = np.empty((256, 4), dtype=np.int8)
    for pos in range(4):
        lut[:, pos] = code_map[(byte_vals >> (2 * pos)) & 0b11]
    return lut


_LUT_A1 = _build_lut(count_a1=True)
_LUT_A2 = _build_lut(count_a1=False)


@dataclasses.dataclass
class BimTable:
    """Parsed .bim columns (chrom, sid, cm, bp, a1, a2)."""

    chrom: np.ndarray  # str array
    sid: np.ndarray  # str array
    bp: np.ndarray  # int64
    a1: np.ndarray
    a2: np.ndarray

    def __len__(self) -> int:
        return len(self.sid)


@dataclasses.dataclass
class FamTable:
    """Parsed .fam columns (fid, iid, pat, mat, sex, pheno)."""

    fid: np.ndarray
    iid: np.ndarray

    def __len__(self) -> int:
        return len(self.iid)


_BIM_KINDS = (native.TABLE_CODES, native.TABLE_JOIN, native.TABLE_SKIP,
              native.TABLE_INT, native.TABLE_CODES, native.TABLE_CODES)
_FAM_KINDS = (native.TABLE_JOIN, native.TABLE_JOIN)


def _read_table(path, kinds, loop):
    """The table's columns in one native pass (io/native.py
    `parse_table_native`), else by `loop(path)`, the line loop that
    defines the values and the errors; counts the rows in
    COUNTS["table_rows_native"] or COUNTS["table_rows_loop"]."""
    columns = native.parse_table_native(Path(path).read_bytes(), kinds)
    which = "native"
    if columns is None:
        columns, which = loop(path), "loop"
    COUNTS[f"table_rows_{which}"] += len(columns[0])
    log.debug("Parsed %s (%d rows) on the %s path.", path, len(columns[0]), which)
    return columns


def _bim_loop(path):
    chroms, sids, bps, a1s, a2s = [], [], [], [], []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 6:
                raise BedFormatError(f"Malformed .bim line in {path}: {line!r}")
            chroms.append(parts[0])
            sids.append(parts[1])
            bps.append(int(parts[3]))
            a1s.append(parts[4])
            a2s.append(parts[5])
    return [np.array(chroms, dtype=object), np.array(sids, dtype=object),
            np.array(bps, dtype=np.int64), np.array(a1s, dtype=object),
            np.array(a2s, dtype=object)]


def _fam_loop(path):
    fids, iids = [], []
    with open(path, "r") as fh:
        for line in fh:
            parts = line.split()
            if not parts:
                continue
            if len(parts) < 2:
                raise BedFormatError(f"Malformed .fam line in {path}: {line!r}")
            fids.append(parts[0])
            iids.append(parts[1])
    return [np.array(fids, dtype=object), np.array(iids, dtype=object)]


def read_bim(path: Union[str, Path]) -> BimTable:
    chrom, sid, bp, a1, a2 = _read_table(path, _BIM_KINDS, _bim_loop)
    return BimTable(chrom=chrom, sid=sid, bp=bp, a1=a1, a2=a2)


def read_fam(path: Union[str, Path]) -> FamTable:
    fid, iid = _read_table(path, _FAM_KINDS, _fam_loop)
    return FamTable(fid=fid, iid=iid)


class BedReader:
    """Random-access reader over a PLINK1 SNP-major .bed file.

    Returns SNP-major (n_snps_selected, n_samples_selected) int8 arrays —
    the natural layout both of the file and of the framework's D x N
    device strips (the reference transposes to the same layout at
    prepare.rs:682-693).
    """

    def __init__(self, prefix: Union[str, Path]):
        prefix = str(prefix)
        if prefix.endswith(".bed"):
            prefix = prefix[:-4]
        self.prefix = prefix
        self.bim = read_bim(prefix + ".bim")
        self.fam = read_fam(prefix + ".fam")
        self.n_snps = len(self.bim)
        self.n_samples = len(self.fam)
        self._bytes_per_snp = (self.n_samples + 3) // 4
        self._mmap = np.memmap(prefix + ".bed", dtype=np.uint8, mode="r")
        if bytes(self._mmap[:3].tobytes()) != _MAGIC:
            raise BedFormatError(f"{prefix}.bed is not a PLINK1 SNP-major .bed file")
        expected = 3 + self._bytes_per_snp * self.n_snps
        if self._mmap.size < expected:
            raise BedFormatError(
                f"{prefix}.bed truncated: {self._mmap.size} bytes, expected {expected}"
            )

    def read_packed(
        self,
        snp_indices: Union[slice, Sequence[int], np.ndarray, None] = None,
    ) -> np.ndarray:
        """Raw 2-bit packed bytes for the selected SNP rows, ALL samples:
        (n_selected, bytes_per_snp) uint8 — zero decode cost; feeds the
        packed device pipeline verbatim (parallel/sharded.py packed
        layout).  Trailing-bit sanitization is the CALLER's duty
        (`sanitize_partial_byte`)."""
        bps = self._bytes_per_snp
        if snp_indices is None:
            snp_indices = slice(0, self.n_snps)
        if isinstance(snp_indices, slice):
            start, stop, step = snp_indices.indices(self.n_snps)
            if step == 1:
                return np.asarray(
                    self._mmap[3 + start * bps : 3 + stop * bps]
                ).reshape(stop - start, bps).copy()
            snp_indices = np.arange(start, stop, step)
        snp_indices = np.asarray(snp_indices, dtype=np.int64)
        # memmap view reshape (no copy); the fancy index faults in only
        # the selected rows' pages.
        body = self._mmap[3 : 3 + self.n_snps * bps].reshape(self.n_snps, bps)
        return np.ascontiguousarray(body[snp_indices])

    def read(
        self,
        snp_indices: Union[slice, Sequence[int], np.ndarray, None] = None,
        sample_indices: Optional[Union[Sequence[int], np.ndarray]] = None,
        count_a1: bool = True,
    ) -> np.ndarray:
        """Decode the selected (snps x samples) block to int8 dosages."""
        lut = _LUT_A1 if count_a1 else _LUT_A2
        bps = self._bytes_per_snp

        if snp_indices is None:
            snp_indices = slice(0, self.n_snps)

        if isinstance(snp_indices, slice):
            start, stop, step = snp_indices.indices(self.n_snps)
            if step != 1:
                snp_indices = np.arange(start, stop, step)
            else:
                # Contiguous fast path.
                nsel = stop - start
                if nsel >= 1024:
                    from genomic_pca_tpu_torch.io.native import decode_bed_native

                    offs = 3 + np.arange(start, stop, dtype=np.int64) * bps
                    geno = decode_bed_native(
                        self._mmap, offs, bps, self.n_samples, count_a1
                    )
                    if geno is not None:
                        if sample_indices is not None:
                            geno = np.ascontiguousarray(
                                geno[:, np.asarray(sample_indices)]
                            )
                        return geno
                raw = np.asarray(
                    self._mmap[3 + start * bps : 3 + stop * bps]
                ).reshape(nsel, bps)
                geno = lut[raw].reshape(nsel, bps * 4)[:, : self.n_samples]
                if sample_indices is not None:
                    geno = geno[:, np.asarray(sample_indices)]
                return np.ascontiguousarray(geno)

        snp_indices = np.asarray(snp_indices, dtype=np.int64)
        offsets = 3 + snp_indices * bps

        # Native multithreaded decode when available and worthwhile.
        if len(snp_indices) >= 1024:
            from genomic_pca_tpu_torch.io.native import decode_bed_native

            geno = decode_bed_native(
                self._mmap, offsets, bps, self.n_samples, count_a1
            )
            if geno is not None:
                if sample_indices is not None:
                    geno = np.ascontiguousarray(
                        geno[:, np.asarray(sample_indices)]
                    )
                return geno

        # numpy gather fallback (mmap handles sparse page touch).
        raw = np.empty((len(snp_indices), bps), dtype=np.uint8)
        mm = self._mmap
        for i, off in enumerate(offsets):
            raw[i] = mm[off : off + bps]
        geno = lut[raw].reshape(len(snp_indices), bps * 4)[:, : self.n_samples]
        if sample_indices is not None:
            geno = geno[:, np.asarray(sample_indices)]
        return np.ascontiguousarray(geno)

    def close(self) -> None:
        del self._mmap


def pack_bed_rows(geno: np.ndarray, count_a1: bool = True) -> np.ndarray:
    """(n_snps, n_samples) int8 dosages -> (n_snps, ceil(n/4)) uint8
    PLINK 2-bit rows (variant-major .bed payload)."""
    geno = np.asarray(geno, dtype=np.int8)
    n_snps, n_samples = geno.shape
    if count_a1:
        # dosage counts A1: 2 -> 00, 1 -> 10, 0 -> 11, missing -> 01
        code_of = {2: 0b00, -127: 0b01, 1: 0b10, 0: 0b11}
    else:
        code_of = {0: 0b00, -127: 0b01, 1: 0b10, 2: 0b11}
    code_map = np.zeros(256, dtype=np.uint8)
    for dosage, code in code_of.items():
        code_map[np.uint8(np.int8(dosage))] = code
    codes = code_map[geno.view(np.uint8)]

    bps = (n_samples + 3) // 4
    padded = np.zeros((n_snps, bps * 4), dtype=np.uint8)
    padded[:, :n_samples] = codes
    return (
        padded[:, 0::4]
        | (padded[:, 1::4] << 2)
        | (padded[:, 2::4] << 4)
        | (padded[:, 3::4] << 6)
    ).astype(np.uint8)


def write_plink_stream(
    prefix: Union[str, Path],
    strips,  # iterator of (n_strip, n_samples) int8 dosage blocks
    n_samples: int,
    chrom: Optional[Sequence[str]] = None,
    bp: Optional[Sequence[int]] = None,
    count_a1: bool = True,
) -> int:
    """Streaming variant of `write_plink` for datasets too large to
    materialize (genome-scale synthetic fixtures): packs and appends one
    strip at a time, then writes BIM/FAM in buffered chunks.  Returns
    the number of SNPs written."""
    prefix = str(prefix)
    n_snps = 0
    with open(prefix + ".bed", "wb") as fh:
        fh.write(_MAGIC)
        for strip in strips:
            strip = np.asarray(strip, dtype=np.int8)
            assert strip.shape[1] == n_samples
            fh.write(pack_bed_rows(strip, count_a1=count_a1).tobytes())
            n_snps += strip.shape[0]

    bp_arr = (
        np.arange(1, n_snps + 1, dtype=np.int64)
        if bp is None
        else np.asarray(bp, dtype=np.int64)
    )
    with open(prefix + ".bim", "w") as fh:
        chunk = 1_000_000
        for lo in range(0, n_snps, chunk):
            hi = min(lo + chunk, n_snps)
            lines = [
                f"{chrom[i] if chrom is not None else '1'}\tsnp{i}\t0\t"
                f"{bp_arr[i]}\tA\tC"
                for i in range(lo, hi)
            ]
            fh.write("\n".join(lines) + "\n")

    with open(prefix + ".fam", "w") as fh:
        fh.write(
            "\n".join(
                f"sample{i}\tsample{i}\t0\t0\t0\t-9" for i in range(n_samples)
            )
            + "\n"
        )
    return n_snps


def write_plink(
    prefix: Union[str, Path],
    genotypes: np.ndarray,
    chrom: Optional[Sequence[str]] = None,
    bp: Optional[Sequence[int]] = None,
    sid: Optional[Sequence[str]] = None,
    iid: Optional[Sequence[str]] = None,
    count_a1: bool = True,
) -> None:
    """Write a (n_snps x n_samples) int8 dosage matrix as PLINK1 files.

    Test/synthetic-data utility (the reference ships binary fixtures only).
    `genotypes` uses the framework conventions: dosages 0/1/2, -127 missing,
    interpreted under `count_a1`.
    """
    prefix = str(prefix)
    geno = np.asarray(genotypes, dtype=np.int8)
    n_snps, n_samples = geno.shape
    packed = pack_bed_rows(geno, count_a1=count_a1)

    with open(prefix + ".bed", "wb") as fh:
        fh.write(_MAGIC)
        fh.write(packed.tobytes())

    if sid is None:
        sid = [f"snp{i}" for i in range(n_snps)]
    if chrom is None:
        chrom = ["1"] * n_snps
    if bp is None:
        bp = list(range(1, n_snps + 1))
    with open(prefix + ".bim", "w") as fh:
        for i in range(n_snps):
            fh.write(f"{chrom[i]}\t{sid[i]}\t0\t{bp[i]}\tA\tC\n")

    if iid is None:
        iid = [f"sample{i}" for i in range(n_samples)]
    with open(prefix + ".fam", "w") as fh:
        for name in iid:
            fh.write(f"{name}\t{name}\t0\t0\t0\t-9\n")

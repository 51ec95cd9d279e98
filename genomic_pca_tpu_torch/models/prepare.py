"""Data preparation of the EigenSNP workflow: sample QC, SNP QC, LD mapping
and the resident matrix, on one device.

Counterpart of `genomic_pca_tpu/models/prepare.py` in its single-process
default: the SNP-QC scan runs on the host (`qc_mode` "auto" or "host"),
counting 2-bit codes straight off the mmap'd BED (native popcounts, numpy
fallback) or, under a sample keep-list, the decoded kept columns.  The
post-QC matrix then uploads once: with `packed_pipeline` (the default) as
raw BED bytes for the full sample set or repacked to 2-bit on the host for
a keep-list; without it as the dense int8 container (`from_arrays` over
decoded strips).  QC decisions and moments are bit-identical to the
reference's (exact integer counts).

`load_matrix` switches to the host-streamed container
(`load_streaming_matrix`, ops/streaming.py) when the resident matrix
would exceed 60% of the device's memory (`will_stream`), as the
reference does; `fetch_block_standardized` and `fetch_block_packed` are
the host block accessors of the EigenSNP stages 1-2 that run without a
resident matrix.

In a process group of several ranks (parallel/mesh.py) the QC scan is
distributed as in the JAX package (genomic_pca_tpu/models/prepare.py
:1209-1300): the BIM rows split into ranges that never bisect an LD block
(`block_aligned_ranges`), each rank scans its own range on the host, and
`_allgather_qc` merges keep / mean / std in BIM order, bit-identical to
one rank's scan (exact integer counts).  `load_matrix` then gives each
rank its own range's survivors as one unit of `from_owned_units`, so
every LD block lies inside one rank and no genotype leaves the rank that
read it; the streamed container stays single-rank (`will_stream` is
False for several ranks).

Not ported yet, refused with an error that says so: the device QC scan
and its QC->matrix capture fusion (`qc_mode="device"`; for
`packed_pipeline=False`, and with several ranks, the reference's "auto"
takes them, and the port takes the host scan, with the same decisions).
"""

from __future__ import annotations

import dataclasses
import logging
from typing import List, Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.errors import ComputeError, DataPrepError
from genomic_pca_tpu_torch.io.bed import BedReader
from genomic_pca_tpu_torch.io.ldblocks import (
    LdBlockSpec, block_aligned_ranges, map_snps_to_blocks, parse_ld_block_file,
)
from genomic_pca_tpu_torch.ops.qc import (
    genotype_counts_int8_host, genotype_counts_packed_host, snp_qc_from_counts,
)
from genomic_pca_tpu_torch.ops.standardize import MISSING
from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.parallel.sharded import (
    PACKED_MISSING_BYTE, ShardedMatrix, dense_cols, inv_std_of, pack_int8_rows,
    packed_cols, sanitize_partial_byte,
)

# Share of the device's memory above which `load_matrix` streams.
STREAMING_SHARE = 0.6

log = logging.getLogger(__name__)

NOT_PORTED = "not yet ported in genomic_pca_tpu_torch"


def device_memory_budget(device) -> int:
    """Memory of `device` in bytes: the card's total memory, or 16 GiB
    for the CPU (the reference's fallback for a device without a limit)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 * (1 << 30)


def _decode_bounded_rows(n_cohort_samples: int, target_bytes: int = 256 << 20) -> int:
    """Rows per decode chunk so that the full-cohort-width int8 array that
    BedReader.read makes before column subsetting stays near
    `target_bytes`."""
    return max(1024, min(262_144, target_bytes // max(n_cohort_samples, 1)))


@dataclasses.dataclass
class PreparedData:
    """QC'd, LD-mapped dataset ready for the EigenSNP core algorithm.

    Index spaces, as in the reference:
      * QcSampleId i  <->  FAM row `qc_sample_indices[i]`
      * PcaSnpId   i  <->  BIM row `pca_snp_orig_indices[i]`
    """

    bed: BedReader
    config: DataPrepConfig
    qc_sample_indices: np.ndarray  # (N,) original FAM indices
    sample_ids: List[str]  # (N,) FAM iids, QcSampleId order
    pca_snp_orig_indices: np.ndarray  # (D,) original BIM indices, sorted
    mean: np.ndarray  # (D,) f32 aligned to PcaSnpId
    std: np.ndarray  # (D,) f32 aligned to PcaSnpId
    blocks: List[LdBlockSpec]
    n_snps_pre_qc: int
    n_snps_post_qc: int
    # Several ranks: each rank's BIM row range [lo, hi), LD-block aligned.
    scan_ranges: Optional[List[tuple]] = None

    @property
    def n_samples(self) -> int:
        return len(self.qc_sample_indices)

    @property
    def n_pca_snps(self) -> int:
        return len(self.pca_snp_orig_indices)

    @property
    def missing_fraction_bound(self) -> float:
        """Upper bound on the post-QC missing fraction: the call-rate
        gate admits at most 1 - min_call_rate missing genotypes per
        surviving SNP.  Drives the adaptive q8 polish count."""
        return max(0.0, 1.0 - float(self.config.min_call_rate))

    def snp_metadata(self):
        """(sids, chroms, positions) aligned to PcaSnpId order."""
        idx = self.pca_snp_orig_indices
        return self.bed.bim.sid[idx], self.bed.bim.chrom[idx], self.bed.bim.bp[idx]

    def _check_missing_policy(self, raw: np.ndarray) -> None:
        if self.config.missing_policy == "error" and (raw == MISSING).any():
            raise DataPrepError(
                "Missing genotype encountered post-QC with "
                "missing_policy='error' (reference accessor semantics, "
                "prepare.rs:1906-1911)."
            )

    def _check_missing_packed(self, raw: np.ndarray) -> None:
        if self.config.missing_policy == "error":
            counts = genotype_counts_packed_host(raw, self.n_samples)
            if (counts[:, 3] < self.n_samples).any():
                raise DataPrepError(
                    "Missing genotype encountered post-QC with "
                    "missing_policy='error' (reference accessor semantics, "
                    "prepare.rs:1906-1911)."
                )

    def fetch_block_standardized(
        self,
        pca_snp_ids: np.ndarray,
        sample_subset: Optional[np.ndarray] = None,
        pad_rows_to: Optional[int] = None,
    ) -> np.ndarray:
        """(snps, samples) f32 standardized block on the host, missing ->
        0, read from the BED: the reference's host block accessor.
        `pad_rows_to` appends inert rows (missing, inv_std 0)."""
        pca_snp_ids = np.asarray(pca_snp_ids, dtype=np.int64)
        orig = self.pca_snp_orig_indices[pca_snp_ids]
        samp = (self.qc_sample_indices if sample_subset is None
                else self.qc_sample_indices[np.asarray(sample_subset)])
        raw = self.bed.read(orig, samp)
        self._check_missing_policy(raw)
        mean = self.mean[pca_snp_ids]
        std = self.std[pca_snp_ids]
        if pad_rows_to is not None and raw.shape[0] < pad_rows_to:
            pad = pad_rows_to - raw.shape[0]
            raw = np.pad(raw, ((0, pad), (0, 0)), constant_values=MISSING)
            mean = np.pad(mean, (0, pad))
            std = np.pad(std, (0, pad))
        inv = inv_std_of(std)
        x = raw.astype(np.float32) * inv[:, None].astype(np.float32) + (
            -mean * inv)[:, None].astype(np.float32)
        return np.where(raw != MISSING, x, np.float32(0.0))

    @property
    def supports_packed_blocks(self) -> bool:
        """True when blocks can be fetched as raw PLINK bytes (packed
        pipeline, full sample set: packed bytes cannot express a column
        subset)."""
        return bool(self.config.packed_pipeline) and (
            len(self.qc_sample_indices) == self.bed.n_samples)

    def fetch_block_packed(self, pca_snp_ids: np.ndarray,
                           pad_rows_to: Optional[int] = None):
        """(packed uint8 (R, packed_cols(N)), mean f32 (R,), inv_std f32
        (R,)) of the requested PcaSnpIds over all samples: raw BED bytes,
        trailing fields sanitized, byte columns padded with 0x55 and rows
        past the block inert (all missing, inv_std 0)."""
        pca_snp_ids = np.asarray(pca_snp_ids, dtype=np.int64)
        raw = sanitize_partial_byte(
            self.bed.read_packed(self.pca_snp_orig_indices[pca_snp_ids]),
            self.n_samples)
        self._check_missing_packed(raw)
        rows = pad_rows_to if pad_rows_to is not None else raw.shape[0]
        out = np.full((rows, packed_cols(self.n_samples)), PACKED_MISSING_BYTE,
                      dtype=np.uint8)
        out[: raw.shape[0], : raw.shape[1]] = raw
        mean = np.zeros(rows, dtype=np.float32)
        inv = np.zeros(rows, dtype=np.float32)
        mean[: raw.shape[0]] = self.mean[pca_snp_ids]
        inv[: raw.shape[0]] = inv_std_of(self.std[pca_snp_ids])
        return out, mean, inv

    def _read_rows(self, lo: int, hi: int, packed: bool) -> np.ndarray:
        """The PCA rows [lo, hi) on the host, read from the BED: with
        `packed` and the full sample set the raw bytes (trailing fields
        sanitized, no decode); with `packed` and a keep-list the kept
        columns decoded and repacked to 2-bit; else the kept samples
        decoded to int8 (-127 missing).  Decodes run in chunks of
        `_decode_bounded_rows` and obey the missing policy."""
        idx = self.pca_snp_orig_indices[lo:hi]
        full = self.n_samples == self.bed.n_samples
        if packed and full:
            return sanitize_partial_byte(self.bed.read_packed(idx), self.n_samples)
        sel = None if full else self.qc_sample_indices
        step = _decode_bounded_rows(self.bed.n_samples)
        parts = []
        for s in range(0, len(idx), step):
            raw = self.bed.read(idx[s:s + step], sel)
            self._check_missing_policy(raw)
            parts.append(pack_int8_rows(raw) if packed else raw)
        return parts[0] if len(parts) == 1 else np.concatenate(parts)

    def estimate_resident_bytes(self) -> int:
        """Device bytes of the resident matrix: 2-bit packed, or int8 with
        128-padded rows for `packed_pipeline=False`."""
        if self.config.packed_pipeline:
            return self.n_pca_snps * packed_cols(self.n_samples)
        return self.n_pca_snps * dense_cols(self.n_samples)

    def estimate_streamed_pass_bytes(self) -> int:
        """Genotype bytes the host-streamed container uploads per pass:
        2-bit packed strips under `packed_pipeline` (a keep-list's columns
        repack on the host), else 128-padded int8."""
        return self.estimate_resident_bytes()

    def will_stream(self, force_streaming: bool = False, device="cuda") -> bool:
        """Whether `load_matrix` takes the host-streamed container: the
        resident matrix would exceed 60% of `device`'s memory (the
        reference's rule), or `force_streaming`; never with several ranks
        (the JAX rule, genomic_pca_tpu/models/prepare.py:677-687)."""
        if force_streaming:
            return True
        return (mesh.process_count() == 1
                and self.estimate_resident_bytes()
                > STREAMING_SHARE * device_memory_budget(device))

    def load_streaming_matrix(self, device, strip_size: int = 2048, **kw):
        """The host-streamed container (ops/streaming.py) on `device`:
        strips of `strip_size` PCA rows read from the BED on every pass.

        Packed pipeline, full sample set: the raw BED bytes of each strip
        (no decode); keep-list: the kept columns decoded and repacked to
        2-bit on the host.  `packed_pipeline=False`: int8 strips of the
        kept samples."""
        from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix

        if self.n_pca_snps == 0:
            raise ComputeError("No PCA SNPs to load.")
        if mesh.process_count() > 1:
            raise ComputeError("The host-streamed container runs on one rank "
                               f"(multi-rank streaming is {NOT_PORTED}).")
        kw.setdefault("missing_fraction", self.missing_fraction_bound)
        n = self.n_pca_snps
        full = self.n_samples == self.bed.n_samples
        packed = bool(self.config.packed_pipeline)

        def rows_of(i: int):
            start = i * strip_size
            end = min(start + strip_size, n)
            return start, end

        def source(i: int):
            start, end = rows_of(i)
            raw = self._read_rows(start, end, packed)
            if packed and full:
                self._check_missing_packed(raw)
            return raw, self.mean[start:end], self.std[start:end]

        return StreamingMatrix(
            source, n_strips=max(1, -(-n // strip_size)), n_rows=n,
            n_samples=self.n_samples, strip_size=strip_size, packed=packed,
            device=device, **kw,
        )

    def _strip_gen(self, strip_size: int):
        """(strips, means, stds) of the PCA rows: decoded int8 strips of
        the kept samples (-127 missing) with their moments, as the
        reference's `_strip_gen` yields them (the full sample set decodes
        without a column gather)."""

        def gen():
            for start in range(0, self.n_pca_snps, strip_size):
                yield self._read_rows(
                    start, min(start + strip_size, self.n_pca_snps), False)

        bounds = range(0, self.n_pca_snps, strip_size)
        return (gen(), [self.mean[s:s + strip_size] for s in bounds],
                [self.std[s:s + strip_size] for s in bounds])

    def load_matrix(self, device, strip_size: int = 2048):
        """The matrix container on `device`: resident, or host-streamed
        (`load_streaming_matrix`) when the resident matrix would exceed
        60% of the device's memory (`will_stream`).

        Resident, packed pipeline, full sample set: the PCA rows' raw BED
        bytes, strip by strip; keep-list: the kept columns decoded per
        strip and repacked to 2-bit on the host.  Both upload into one
        preallocated device block (`from_packed_strips`), so the device
        never holds a second copy.  `packed_pipeline=False`: the dense
        int8 container from decoded strips of `strip_size` rows
        (`from_arrays`)."""
        if self.n_pca_snps == 0:
            raise ComputeError("No PCA SNPs to load.")
        if self.will_stream(device=device):
            log.warning(
                "Genotype matrix (%.1f GB) exceeds 60%% of device memory "
                "(%.1f GB); using the host-streamed container.",
                self.estimate_resident_bytes() / 1e9,
                device_memory_budget(device) / 1e9)
            return self.load_streaming_matrix(device, strip_size=strip_size)
        if mesh.process_count() > 1:
            return self._load_matrix_ranks(device)
        if not self.config.packed_pipeline:
            gen, means, stds = self._strip_gen(strip_size)
            return ShardedMatrix.from_arrays(
                gen, means=means, stds=stds, device=device,
                missing_fraction=self.missing_fraction_bound,
            )
        sm = ShardedMatrix.from_packed_strips(
            lambda lo, hi: self._read_rows(lo, hi, True), n_rows=self.n_pca_snps, mean=self.mean, std=self.std,
            n_samples=self.n_samples, device=device,
            missing_fraction=self.missing_fraction_bound,
        )
        self._check_no_missing(sm)
        return sm

    def _check_no_missing(self, sm) -> None:
        if self.config.missing_policy == "error" and sm.count_missing():
            raise DataPrepError(
                "Missing genotypes present post-QC with "
                "missing_policy='error' (reference accessor "
                "semantics, prepare.rs:1906-1911)."
            )

    def _load_matrix_ranks(self, device):
        """The resident matrix over the ranks: rank r reads the survivors
        of its own scan range strip by strip (`_read_rows`: raw BED bytes
        for the full sample set, the kept columns decoded and repacked
        under a keep-list, decoded int8 with `packed_pipeline=False`) into
        one unit of `from_owned_units`; the survivor counts of every range
        are known to every rank from the merged QC."""
        rank, world = mesh.process_index(), mesh.process_count()
        pca = self.pca_snp_orig_indices
        ranges = self.scan_ranges
        bounds = np.searchsorted(pca, [lo for lo, _hi in ranges] + [ranges[-1][1]])
        counts = np.diff(bounds)
        b0, b1 = int(bounds[rank]), int(bounds[rank + 1])
        packed = bool(self.config.packed_pipeline)
        local = {}
        if b1 > b0:
            local[rank] = (lambda lo, hi: self._read_rows(b0 + lo, b0 + hi, packed),
                           self.mean[b0:b1], self.std[b0:b1])
        log.info("Rank %d/%d holds PCA rows [%d, %d) of %d (%s).", rank, world,
                 b0, b1, len(pca), "packed" if packed else "int8")
        sm = ShardedMatrix.from_owned_units(
            counts, np.arange(world), local, n_samples=self.n_samples,
            device=device, packed=packed,
            missing_fraction=self.missing_fraction_bound,
        )
        self._check_no_missing(sm)
        return sm


def perform_sample_qc(bed: BedReader, keep_path: Optional[str]) -> np.ndarray:
    """Keep-list intersection preserving FAM order."""
    n = bed.n_samples
    if keep_path is None:
        log.info("No sample keep-list provided; using all %d samples.", n)
        return np.arange(n, dtype=np.int64)
    with open(keep_path, "r") as fh:
        keep = {line.rstrip("\n").rstrip("\r") for line in fh}
    idx = np.array(
        [i for i, iid in enumerate(bed.fam.iid) if iid in keep], dtype=np.int64
    )
    log.info("Sample QC: %d / %d samples selected.", len(idx), n)
    return idx


def _qc_snp_range_hostscan(
    bed: BedReader,
    config: DataPrepConfig,
    n_qc: int,
    lo: int,
    hi: int,
    sample_sel: Optional[np.ndarray] = None,
):
    """Host SNP-QC scan over BIM rows [lo, hi): (keep bool, mean, std).

    Full sample set: 2-bit code counts straight off the mmap'd BED bytes
    (native popcounts, numpy fallback).  Keep-list: the int8 dosages of
    the kept columns, decoded per chunk.  Filtering runs per chunk, so
    temporaries stay chunk-sized; a chunk that fails to read is logged
    and its SNPs excluded, as in the reference tool's QC path."""
    from genomic_pca_tpu_torch.io.native import packed_qc_counts_native

    chunk_rows = 262_144
    if sample_sel is not None:
        chunk_rows = _decode_bounded_rows(bed.n_samples)
    n_chunks = max(1, -(-(hi - lo) // chunk_rows))
    keeps: List[np.ndarray] = []
    means: List[np.ndarray] = []
    stds: List[np.ndarray] = []
    for ci, start in enumerate(range(lo, hi, chunk_rows)):
        end = min(start + chunk_rows, hi)
        try:
            if sample_sel is not None:
                counts = genotype_counts_int8_host(
                    bed.read(slice(start, end), sample_sel)
                )
            else:
                offs = 3 + np.arange(start, end, dtype=np.int64) * bed._bytes_per_snp
                counts = packed_qc_counts_native(bed._mmap, offs, bed.n_samples)
                if counts is None:
                    counts = genotype_counts_packed_host(
                        bed.read_packed(slice(start, end)), bed.n_samples
                    )
        except (OSError, ValueError) as e:
            log.warning("SNP QC chunk %d-%d failed (%s); excluding its SNPs.",
                        start, end, e)
            counts = np.zeros((end - start, 4), dtype=np.int32)
        qc = snp_qc_from_counts(counts[:, 0], counts[:, 1], counts[:, 2],
                                counts[:, 3], n_qc, config)
        keeps.append(qc.keep)
        means.append(qc.mean)
        stds.append(qc.std)
        if (ci + 1) % max(1, n_chunks // 20) == 0 or ci + 1 == n_chunks:
            log.info("SNP QC host scan: chunk %d/%d (%.0f%%).",
                     ci + 1, n_chunks, 100.0 * (ci + 1) / n_chunks)
    if not keeps:
        return (np.zeros(0, dtype=bool), np.zeros(0, dtype=np.float32),
                np.zeros(0, dtype=np.float32))
    return np.concatenate(keeps), np.concatenate(means), np.concatenate(stds)


def _allgather_qc(keep: np.ndarray, mean: np.ndarray, std: np.ndarray,
                  ranges: List[tuple]):
    """Merge the ranks' QC results of contiguous (possibly unequal) scan
    ranges into (keep, mean, std) in BIM order, on every rank: the JAX
    `_allgather_qc` (genomic_pca_tpu/models/prepare.py:1170-1206).  Each
    rank pads its rows to the longest range (keep False) so that the
    gather has one shape; the moments travel as float64, which holds the
    scan's values exactly."""
    max_len = max(hi - lo for lo, hi in ranges)
    pad = max_len - len(keep)
    got = mesh.all_gather_numpy({
        "keep": np.pad(np.asarray(keep, np.bool_), (0, pad)),
        "mean": np.pad(np.asarray(mean, np.float64), (0, pad)),
        "std": np.pad(np.asarray(std, np.float64), (0, pad)),
    })
    return tuple(
        np.concatenate([got[key][r, : hi - lo] for r, (lo, hi) in enumerate(ranges)])
        for key in ("keep", "mean", "std"))


def prepare_data(config: DataPrepConfig) -> PreparedData:
    """Sample QC -> host SNP-QC scan -> LD mapping.  With several ranks
    and `config.distributed_qc` each rank scans only its LD-block aligned
    range of BIM rows and the results merge (`_allgather_qc`),
    bit-identical to the scan of one rank."""
    if config.qc_mode not in ("auto", "host", "device"):
        raise DataPrepError(
            f"qc_mode must be 'auto', 'host', or 'device', got {config.qc_mode!r}"
        )
    if config.qc_mode == "device":
        raise DataPrepError(
            "qc_mode='device' (the device QC scan and its QC->matrix "
            f"capture fusion) is {NOT_PORTED}; use 'auto' or 'host'."
        )
    bed = BedReader(config.bed_path)
    qc_samples = perform_sample_qc(bed, config.sample_keep_path)
    n_qc = len(qc_samples)
    if n_qc == 0:
        raise DataPrepError("Sample QC left 0 samples.")
    sample_sel = None if n_qc == bed.n_samples else qc_samples
    parsed_blocks = parse_ld_block_file(config.ld_block_path)
    log.info("SNP QC: host-side %s scan (qc_mode=%s).",
             "packed" if sample_sel is None else "decoded-subset", config.qc_mode)
    if config.qc_mode == "auto" and not config.packed_pipeline:
        log.info("SNP QC: packed_pipeline=False takes the host scan here; the "
                 "JAX package's device scan and QC->matrix capture fusion are "
                 "%s (QC decisions are the same: exact integer counts).",
                 NOT_PORTED)
    rank, world = mesh.process_index(), mesh.process_count()
    scan_ranges = None
    if world > 1:
        if config.qc_mode == "auto":
            log.info("SNP QC: %d ranks take the host scan; the JAX package's "
                     "device scan and QC->matrix capture fusion are %s (QC "
                     "decisions are the same: exact integer counts).", world,
                     NOT_PORTED)
        # The ranges also place the matrix rows (load_matrix), so they are
        # computed whether or not the scan is split.
        scan_ranges = block_aligned_ranges(bed.bim.chrom, bed.bim.bp,
                                           parsed_blocks, world)
    if scan_ranges is not None and config.distributed_qc:
        lo, hi = scan_ranges[rank]
        log.info("Distributed SNP QC: rank %d/%d scans rows [%d, %d).", rank,
                 world, lo, hi)
        keep, mean_all, std_all = _allgather_qc(*_qc_snp_range_hostscan(
            bed, config, n_qc, lo, hi, sample_sel=sample_sel), scan_ranges)
    else:
        keep, mean_all, std_all = _qc_snp_range_hostscan(
            bed, config, n_qc, 0, bed.n_snps, sample_sel=sample_sel
        )
    qc_orig = np.nonzero(keep)[0]
    log.info("SNP QC: %d / %d SNPs passed.", len(qc_orig), bed.n_snps)

    blocks, pca_orig = map_snps_to_blocks(
        bed.bim.chrom[qc_orig], bed.bim.bp[qc_orig], qc_orig, parsed_blocks,
    )
    log.info("LD mapping: %d QC'd SNPs -> %d PCA SNPs across %d blocks.",
             len(qc_orig), len(pca_orig), len(blocks))
    return PreparedData(
        bed=bed,
        config=config,
        qc_sample_indices=qc_samples,
        sample_ids=[str(s) for s in bed.fam.iid[qc_samples]],
        pca_snp_orig_indices=pca_orig,
        mean=mean_all[pca_orig].astype(np.float32),
        std=std_all[pca_orig].astype(np.float32),
        blocks=blocks,
        n_snps_pre_qc=bed.n_snps,
        n_snps_post_qc=len(qc_orig),
        scan_ranges=scan_ranges,
    )

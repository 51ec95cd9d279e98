"""Data preparation of the EigenSNP workflow: sample QC, SNP QC, LD mapping
and the matrix container.

Counterpart of `genomic_pca_tpu/models/prepare.py`.  The SNP-QC scan
counts exact integer genotype histograms, so every QC decision and
moment is the same whichever scan runs (`qc_mode`):

- the host scan ("host"; "auto" with `packed_pipeline` on one rank)
  counts 2-bit codes straight off the mmap'd BED (native popcounts,
  numpy fallback) or, under a sample keep-list, the decoded kept columns;
  nothing uploads until `load_matrix`;
- the device scan ("device"; "auto" with `packed_pipeline=False`, and
  "auto" with several ranks) uploads each batch of `qc_device_batch` BIM
  rows once, as PLINK bytes for the full sample set or as int8 dosages of
  the kept samples, from one of two pinned staging buffers (a buffer is
  refilled only after an event shows its last copy finished), and counts
  it on the device (ops/qc.py `genotype_counts(_packed)`).  The counts
  stay on the device and come back in one fetch after the loop; without
  a capture the host waits on a fence every 4 batches.

The QC->matrix capture fusion (`fuse_qc_matrix`) keeps the device scan's
batches (`QcCapture`) when the pre-QC bytes of the largest scan range fit
45% of one rank's share of its device, and `load_matrix` then gathers the
PCA rows from them with `index_select` instead of re-reading the BED:
bit for bit the container the re-read builds (geno, mean, inv_std,
n_rows, the per-rank row padding; a keep-list's int8 batches are
repacked to 2-bit on the device under `packed_pipeline`).  Batches are
released as the assembly passes them.  A capture that does not fit is
the JAX rule's decision, logged; `load_matrix` then re-reads the BED.

The post-QC matrix otherwise uploads once: with `packed_pipeline` (the
default) as raw BED bytes for the full sample set or repacked to 2-bit on
the host for a keep-list; without it as the dense int8 container.
`load_matrix` switches to the host-streamed container
(`load_streaming_matrix`, ops/streaming.py) when the resident matrix
would exceed 60% of the group's memory (the sum over its distinct
devices; `will_stream`), as the reference does; `fetch_block_standardized`
and `fetch_block_packed` are the host block accessors of the EigenSNP
stages 1-2 that run without a resident matrix.

In a process group of several ranks (parallel/mesh.py) the QC scan is
distributed as in the JAX package (genomic_pca_tpu/models/prepare.py
:1209-1300): the BIM rows split into ranges that never bisect an LD block
(`block_aligned_ranges`), each rank scans its own range, and
`_allgather_qc` merges keep / mean / std in BIM order, bit-identical to
one rank's scan.  `load_matrix` then gives each rank its own range's
survivors as one unit of `from_owned_units` (from its captured batches,
or re-read from the BED), so every LD block lies inside one rank and no
genotype leaves the rank that read it; the streamed container deals its
strips round-robin over the ranks.  The capture and streaming decisions
come from numbers every rank holds (the merged QC, the gathered device
budgets), so every rank takes the same branch.
"""

from __future__ import annotations

import dataclasses
import logging
import socket
from collections import Counter
from typing import Dict, List, Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.errors import ComputeError, DataPrepError
from genomic_pca_tpu_torch.io.bed import BedReader
from genomic_pca_tpu_torch.io.ldblocks import (
    LdBlockSpec, block_aligned_ranges, map_snps_to_blocks, parse_ld_block_file,
)
from genomic_pca_tpu_torch.ops.qc import (
    genotype_counts, genotype_counts_int8_host, genotype_counts_packed,
    genotype_counts_packed_host, snp_qc_from_counts,
)
from genomic_pca_tpu_torch.ops.standardize import MISSING
from genomic_pca_tpu_torch.parallel import mesh
from genomic_pca_tpu_torch.parallel.sharded import (
    PACKED_MISSING_BYTE, ShardedMatrix, dense_cols, inv_std_of, pack_int8_rows,
    packed_cols, sanitize_partial_byte,
)
from genomic_pca_tpu_torch.utils.profiling import span

# Share of the group's memory above which `load_matrix` streams.
STREAMING_SHARE = 0.6
# Share of one rank's device memory that the QC capture may hold.
CAPTURE_SHARE = 0.45

log = logging.getLogger(__name__)


def device_memory_budget(device) -> int:
    """Memory of `device` in bytes: the card's total memory, or 16 GiB
    for the CPU (the reference's fallback for a device without a limit)."""
    device = torch.device(device)
    if device.type == "cuda":
        return int(torch.cuda.get_device_properties(device).total_memory)
    return 16 * (1 << 30)


def _group_budgets(device) -> tuple:
    """(the group's memory, one rank's share): the sum of
    `device_memory_budget` over the group's distinct devices (the JAX
    `_device_memory_budget` sums a process's local devices), and the
    least over the ranks of its device's memory divided by the ranks that
    share that device.  Gathered from every rank, so every rank gets the
    same two numbers; without a process group, the device's memory
    twice."""
    ranks = mesh.all_gather_object(
        (socket.gethostname(), str(torch.device(device)), device_memory_budget(device)))
    sharing = Counter((host, dev) for host, dev, _ in ranks)
    total = sum({(host, dev): b for host, dev, b in ranks}.values())
    return total, min(b // sharing[(host, dev)] for host, dev, b in ranks)


def group_memory_budget(device) -> int:
    """The memory of the group's distinct devices (`_group_budgets`)."""
    return _group_budgets(device)[0]


def _resolve_device(device) -> torch.device:
    """`device`, or this rank's card when it is None."""
    return mesh.rank_device("cuda") if device is None else torch.device(device)


def _decode_bounded_rows(n_cohort_samples: int, target_bytes: int = 256 << 20) -> int:
    """Rows per decode chunk so that the full-cohort-width int8 array that
    BedReader.read makes before column subsetting stays near
    `target_bytes`."""
    return max(1024, min(262_144, target_bytes // max(n_cohort_samples, 1)))


@dataclasses.dataclass
class QcCapture:
    """The device scan's genotype batches, kept for the matrix assembly
    (`fuse_qc_matrix`): `batch_rows` BIM rows each, in scan order from
    the rank's range start; PLINK bytes padded to `packed_cols` with
    `packed`, else int8 dosages of the kept samples padded to
    `dense_cols` with -127.  The JAX `QcCapture`."""

    batch_rows: int = 0
    batches: List[Optional[torch.Tensor]] = dataclasses.field(default_factory=list)
    packed: bool = False


def _pack_rows_device(x: torch.Tensor, cols: int) -> torch.Tensor:
    """(rows, w) int8 dosages, -127 missing and w a multiple of 4, to
    (rows, cols) PLINK bytes on their device: the bytes of
    `pack_int8_rows` over the real samples (missing pad samples make the
    trailing fields 01) and 0x55 beyond, the layout of a packed
    container row."""
    code = torch.where(x == MISSING, 1, torch.where(x == 1, 2, torch.where(
        x == 0, 3, 0))).to(torch.uint8)
    code = code.view(x.shape[0], -1, 4)
    byte = code[..., 0] | (code[..., 1] << 2) | (code[..., 2] << 4) | (code[..., 3] << 6)
    out = torch.full((x.shape[0], cols), PACKED_MISSING_BYTE, dtype=torch.uint8,
                     device=x.device)
    out[:, : byte.shape[1]] = byte
    return out


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
    # The device scan's batches, when the capture fusion holds them.
    qc_capture: Optional[QcCapture] = None
    # Seconds of the preparation's spans: "open" (BIM and FAM parse),
    # "qc_scan" (the SNP-QC scan and its merge), "ld_map" (the block
    # file's parse and the SNPs' mapping to blocks).
    stage_seconds: Dict[str, float] = dataclasses.field(default_factory=dict)

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
        128-padded rows for `packed_pipeline=False`.  The capture
        assembles the same container (a keep-list's int8 batches repack
        to 2-bit on the device), so, unlike the JAX estimate, this one
        does not depend on the capture."""
        if self.config.packed_pipeline:
            return self.n_pca_snps * packed_cols(self.n_samples)
        return self.n_pca_snps * dense_cols(self.n_samples)

    def estimate_streamed_pass_bytes(self) -> int:
        """Genotype bytes the host-streamed container uploads per pass:
        2-bit packed strips under `packed_pipeline` (a keep-list's columns
        repack on the host), else 128-padded int8."""
        return self.estimate_resident_bytes()

    def will_stream(self, force_streaming: bool = False, device=None) -> bool:
        """Whether `load_matrix` takes the host-streamed container: the
        resident matrix would exceed 60% of the group's memory
        (`group_memory_budget`: the JAX rule over a process's devices,
        genomic_pca_tpu/models/prepare.py:677-687, over the group's), or
        `force_streaming`.  Every rank gets the same answer: the merged QC
        and the gathered budgets are the same on every rank."""
        if force_streaming:
            return True
        return (self.estimate_resident_bytes()
                > STREAMING_SHARE * group_memory_budget(_resolve_device(device)))

    def load_streaming_matrix(self, device=None, strip_size: int = 2048, **kw):
        """The host-streamed container (ops/streaming.py) on `device`:
        strips of `strip_size` PCA rows read from the BED on every pass,
        strip i on rank i mod R, each rank from its own mmap.  Drops the
        QC capture: no pass reads it.

        Packed pipeline, full sample set: the raw BED bytes of each strip
        (no decode); keep-list: the kept columns decoded and repacked to
        2-bit on the host.  `packed_pipeline=False`: int8 strips of the
        kept samples."""
        from genomic_pca_tpu_torch.ops.streaming import StreamingMatrix

        self.qc_capture = None
        if self.n_pca_snps == 0:
            raise ComputeError("No PCA SNPs to load.")
        kw.setdefault("missing_fraction", self.missing_fraction_bound)
        n = self.n_pca_snps
        full = self.n_samples == self.bed.n_samples
        packed = bool(self.config.packed_pipeline)

        def source(i: int):
            start = i * strip_size
            end = min(start + strip_size, n)
            raw = self._read_rows(start, end, packed)
            if packed and full:
                self._check_missing_packed(raw)
            return raw, self.mean[start:end], self.std[start:end]

        return StreamingMatrix(
            source, n_strips=max(1, -(-n // strip_size)), n_rows=n,
            n_samples=self.n_samples, strip_size=strip_size, packed=packed,
            device=_resolve_device(device), **kw,
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

    def load_matrix(self, device=None, strip_size: int = 2048):
        """The matrix container on `device` (this rank's card when None):
        resident, or host-streamed (`load_streaming_matrix`) when the
        resident matrix would exceed 60% of the group's memory
        (`will_stream`).

        With a QC capture the resident matrix is gathered from the scan's
        device batches (`_capture_reader`), bit for bit the re-read one.
        Else, packed pipeline, full sample set: the PCA rows' raw BED
        bytes, strip by strip; keep-list: the kept columns decoded per
        strip and repacked to 2-bit on the host.  Both upload into one
        preallocated device block (`from_packed_strips`), so the device
        never holds a second copy.  `packed_pipeline=False`: the dense
        int8 container from decoded strips of `strip_size` rows
        (`from_arrays`)."""
        if self.n_pca_snps == 0:
            raise ComputeError("No PCA SNPs to load.")
        device = _resolve_device(device)
        if self.will_stream(device=device):
            log.warning(
                "Genotype matrix (%.1f GB) exceeds 60%% of the memory of the "
                "group's devices (%.1f GB); using the host-streamed container.",
                self.estimate_resident_bytes() / 1e9,
                group_memory_budget(device) / 1e9)
            return self.load_streaming_matrix(device, strip_size=strip_size)
        if mesh.process_count() > 1:
            return self._load_matrix_ranks(device)
        if self.qc_capture is not None:
            return self._matrix_from_capture(device)
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

    def _capture_reader(self, rows: np.ndarray, device):
        """`read(a, b)`: the container rows of capture rows `rows[a:b]`
        (row numbers from the scan range's start, ascending) on `device`,
        gathered from the QC capture's batches with `index_select`; PLINK
        bytes padded to `packed_cols` under `packed_pipeline` (a keep-list's
        int8 batches repacked here), else int8 padded to `dense_cols`.
        Reads go in ascending order, and each releases the batches no
        later read needs."""
        cap = self.qc_capture
        repack = bool(self.config.packed_pipeline) and not cap.packed
        cols = packed_cols(self.n_samples)
        step = cap.batch_rows

        def read(a: int, b: int) -> torch.Tensor:
            idx = rows[a:b]
            parts = []
            for bi in np.unique(idx // step):
                g = cap.batches[bi]
                sel = torch.as_tensor(idx[idx // step == bi] % step, device=g.device)
                parts.append(g.index_select(0, sel))
            x = parts[0] if len(parts) == 1 else torch.cat(parts)
            if repack:
                x = _pack_rows_device(x, cols)
            live = int(rows[b] // step) if b < len(rows) else len(cap.batches)
            cap.batches[:live] = [None] * live
            return x.to(device)

        return read

    def _matrix_from_capture(self, device):
        """The one-rank resident matrix from the QC capture: one
        preallocated device block filled batch by batch
        (`_capture_reader`), the moments as `from_packed_strips` /
        `from_arrays` make them; no BED re-read, no second upload.  The
        JAX `_matrix_from_capture` (genomic_pca_tpu/models/prepare.py
        :396-483)."""
        d, n = self.n_pca_snps, self.n_samples
        log.info("Matrix assembly from the QC scan's device batches (no BED "
                 "re-read, no second upload).")
        read = self._capture_reader(self.pca_snp_orig_indices, device)
        packed = bool(self.config.packed_pipeline)
        geno = torch.empty((d, packed_cols(n) if packed else dense_cols(n)),
                           dtype=torch.uint8 if packed else torch.int8, device=device)
        step = self.qc_capture.batch_rows
        for lo in range(0, d, step):
            hi = min(lo + step, d)
            geno[lo:hi] = read(lo, hi)
        self.qc_capture = None
        m, iv = ShardedMatrix._moments(self.mean, self.std, d, device)
        sm = ShardedMatrix(geno, m, iv, d, n, device,
                           missing_fraction=self.missing_fraction_bound)
        self._check_no_missing(sm)
        return sm

    def _load_matrix_ranks(self, device):
        """The resident matrix over the ranks: rank r holds the survivors
        of its own scan range as one unit of `from_owned_units`, gathered
        from its QC capture's batches (the JAX
        `_matrix_from_capture_multiproc`, genomic_pca_tpu/models/prepare.py
        :485-652) or read from the BED strip by strip (`_read_rows`: raw
        BED bytes for the full sample set, the kept columns decoded and
        repacked under a keep-list, decoded int8 with
        `packed_pipeline=False`); the survivor counts of every range are
        known to every rank from the merged QC."""
        rank, world = mesh.process_index(), mesh.process_count()
        pca = self.pca_snp_orig_indices
        ranges = self.scan_ranges
        bounds = np.searchsorted(pca, [lo for lo, _hi in ranges] + [ranges[-1][1]])
        counts = np.diff(bounds)
        b0, b1 = int(bounds[rank]), int(bounds[rank + 1])
        packed = bool(self.config.packed_pipeline)
        strip_rows = {}
        if self.qc_capture is not None:
            read = self._capture_reader(pca[b0:b1] - ranges[rank][0], device)
            strip_rows["strip_rows"] = self.qc_capture.batch_rows
        else:
            def read(lo, hi):
                return self._read_rows(b0 + lo, b0 + hi, packed)
        local = {rank: (read, self.mean[b0:b1], self.std[b0:b1])} if b1 > b0 else {}
        log.info("Rank %d/%d holds PCA rows [%d, %d) of %d (%s, %s).", rank, world,
                 b0, b1, len(pca), "packed" if packed else "int8",
                 "from its QC capture" if strip_rows else "read from the BED")
        sm = ShardedMatrix.from_owned_units(
            counts, np.arange(world), local, n_samples=self.n_samples,
            device=device, packed=packed,
            missing_fraction=self.missing_fraction_bound, **strip_rows,
        )
        self.qc_capture = None
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


def _fill_batch(host: np.ndarray, bed: BedReader, bstart: int, bend: int,
                chunk: int, sample_sel: Optional[np.ndarray], packed: bool) -> None:
    """BIM rows [bstart, bend) into the host batch buffer: PLINK bytes
    (trailing fields sanitized) or int8 dosages of the kept samples, read
    `chunk` rows at a time; every other entry missing.  A chunk that
    fails to read is logged and stays missing, so QC excludes its SNPs,
    as in the reference tool's QC path."""
    host[...] = PACKED_MISSING_BYTE if packed else MISSING
    n = bed.n_samples if sample_sel is None else len(sample_sel)
    for start in range(bstart, bend, chunk):
        end = min(start + chunk, bend)
        try:
            if packed:
                rows = sanitize_partial_byte(bed.read_packed(slice(start, end)), n)
            else:
                rows = bed.read(slice(start, end), sample_sel)
        except (OSError, ValueError) as e:
            log.warning("SNP QC chunk %d-%d failed (%s); excluding its SNPs.",
                        start, end, e)
            continue
        host[start - bstart:end - bstart, : rows.shape[1]] = rows


def _qc_snp_range(
    bed: BedReader,
    config: DataPrepConfig,
    sample_sel: Optional[np.ndarray],
    n_qc: int,
    lo: int,
    hi: int,
    device,
    capture: Optional[QcCapture] = None,
    packed: bool = False,
):
    """Device SNP-QC scan over BIM rows [lo, hi): (keep bool, mean, std).
    The JAX `_qc_snp_range` (genomic_pca_tpu/models/prepare.py:931-1076).

    Batches of `qc_device_batch` rows (a multiple of `snp_chunk_size`)
    upload once each: PLINK bytes padded to `packed_cols` with `packed`
    (the full sample set), else int8 dosages of the kept samples padded
    to `dense_cols`, every pad entry missing.  On a card a batch goes up
    from one of two pinned staging buffers, refilled only after an event
    shows that its last copy finished, so the next batch's BED read
    overlaps the copy.  The counts (ops/qc.py) stay on the device and
    come back in one fetch after the loop; without `capture` the host
    waits on a fence every 4 batches, which bounds the batches in flight.
    With `capture` every batch stays on the device in `capture.batches`."""
    device = torch.device(device)
    chunk = config.snp_chunk_size
    batch_rows = -(-max(chunk, config.qc_device_batch) // chunk) * chunk
    cols = packed_cols(n_qc) if packed else dense_cols(n_qc)
    dtype = torch.uint8 if packed else torch.int8
    if capture is not None:
        capture.batch_rows = batch_rows
        capture.packed = packed
    cuda = device.type == "cuda"
    staging = ([torch.empty((batch_rows, cols), dtype=dtype, pin_memory=True)
                for _ in range(2)] if cuda else None)
    copied: List[Optional[torch.cuda.Event]] = [None, None]
    counts_dev: List[torch.Tensor] = []
    n_batches = max(1, -(-(hi - lo) // batch_rows))
    for bi, bstart in enumerate(range(lo, hi, batch_rows)):
        bend = min(bstart + batch_rows, hi)
        if cuda:
            slot = bi % 2
            if copied[slot] is not None:
                copied[slot].synchronize()
            _fill_batch(staging[slot].numpy(), bed, bstart, bend, chunk,
                        sample_sel, packed)
            g = torch.empty((batch_rows, cols), dtype=dtype, device=device)
            g.copy_(staging[slot], non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record()
        else:
            host = np.empty((batch_rows, cols), dtype=np.uint8 if packed else np.int8)
            _fill_batch(host, bed, bstart, bend, chunk, sample_sel, packed)
            g = torch.from_numpy(host).to(device)
        counts = genotype_counts_packed(g, n_qc) if packed else genotype_counts(g)
        counts_dev.append(torch.stack(counts))
        if capture is not None:
            capture.batches.append(g)
        elif bi % 4 == 3:
            counts_dev[bi - 3][0, :1].cpu()
        if (bi + 1) % max(1, n_batches // 20) == 0 or bi + 1 == n_batches:
            log.info("SNP QC device scan: batch %d/%d (%.0f%%) read and "
                     "dispatched.", bi + 1, n_batches, 100.0 * (bi + 1) / n_batches)
    if not counts_dev:
        return (np.zeros(0, dtype=bool), np.zeros(0, dtype=np.float32),
                np.zeros(0, dtype=np.float32))
    # Rows past `hi` in the last batch are missing pad rows: cut off.
    counts = torch.cat(counts_dev, dim=1)[:, : hi - lo].cpu().numpy()
    # Filtered in chunks, as the host scan filters, so that temporaries
    # stay chunk-sized.
    parts = [snp_qc_from_counts(*counts[:, s:s + 262_144], n_qc, config)
             for s in range(0, hi - lo, 262_144)]
    return tuple(np.concatenate([getattr(qc, key) for qc in parts])
                 for key in ("keep", "mean", "std"))


def _capture_if_fits(max_rows: int, n_qc: int, packed: bool, device) -> Optional[QcCapture]:
    """A QcCapture when `max_rows` pre-QC rows (the largest scan range)
    fit 45% of one rank's share of its device (the JAX rule,
    genomic_pca_tpu/models/prepare.py:1269-1281), else None, logged.
    Every rank reaches the same answer (`_group_budgets`)."""
    pre_qc = max_rows * (packed_cols(n_qc) if packed else dense_cols(n_qc))
    share = _group_budgets(device)[1]
    if pre_qc <= CAPTURE_SHARE * share:
        log.info("QC->matrix capture: the scan keeps its %s batches on the "
                 "device (%.2f GB pre-QC, within 45%% of %.1f GB).",
                 "packed" if packed else "int8", pre_qc / 1e9, share / 1e9)
        return QcCapture()
    log.info("QC->matrix capture skipped: %.2f GB pre-QC exceeds 45%% of one "
             "rank's %.1f GB device share; load_matrix re-reads the BED.",
             pre_qc / 1e9, share / 1e9)
    return None


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


def prepare_data(config: DataPrepConfig, device=None) -> PreparedData:
    """Sample QC -> SNP-QC scan -> LD mapping (the JAX `prepare_data`,
    genomic_pca_tpu/models/prepare.py:1209-1300).

    The scan: the host scan for `qc_mode="host"` and for "auto" with
    `packed_pipeline` on one rank; else the device scan on `device`
    (this rank's card when None), with the QC->matrix capture when
    `fuse_qc_matrix` and the pre-QC bytes fit (`_capture_if_fits`).
    With several ranks and `config.distributed_qc` each rank scans only
    its LD-block aligned range of BIM rows ("auto" takes the device scan
    there) and the results merge (`_allgather_qc`), bit-identical to the
    scan of one rank; without `distributed_qc` every rank scans every row
    and nothing is captured.  All of it is the span `gp.prepare`, holding
    `gp.prepare.open`, `gp.prepare.qc_scan` and `gp.prepare.ld_map` (two
    ranges: the block file's parse, then the mapping), whose seconds make
    the result's `stage_seconds`."""
    if config.qc_mode not in ("auto", "host", "device"):
        raise DataPrepError(
            f"qc_mode must be 'auto', 'host', or 'device', got {config.qc_mode!r}"
        )
    with span("gp.prepare"):
        return _prepare(config, device)


def _prepare(config: DataPrepConfig, device) -> PreparedData:
    with span("gp.prepare.open") as opened:
        bed = BedReader(config.bed_path)
    qc_samples = perform_sample_qc(bed, config.sample_keep_path)
    n_qc = len(qc_samples)
    if n_qc == 0:
        raise DataPrepError("Sample QC left 0 samples.")
    sample_sel = None if n_qc == bed.n_samples else qc_samples
    # Raw PLINK bytes whenever the full sample set is in play.
    packed = bool(config.packed_pipeline) and sample_sel is None
    with span("gp.prepare.ld_map") as parsed:
        parsed_blocks = parse_ld_block_file(config.ld_block_path)
    rank, world = mesh.process_index(), mesh.process_count()
    scan_ranges = None
    if world > 1:
        # The ranges also place the matrix rows (load_matrix), so they are
        # computed whether or not the scan is split.
        scan_ranges = block_aligned_ranges(bed.bim.chrom, bed.bim.bp,
                                           parsed_blocks, world)
    capture: Optional[QcCapture] = None
    host_scan = config.qc_mode == "host" or (
        config.qc_mode == "auto" and config.packed_pipeline
        and (world == 1 or not config.distributed_qc))
    lo, hi = 0, bed.n_snps
    if scan_ranges is not None and config.distributed_qc:
        lo, hi = scan_ranges[rank]
        log.info("Distributed SNP QC: rank %d/%d scans rows [%d, %d).", rank,
                 world, lo, hi)
    with span("gp.prepare.qc_scan") as scanned:
        if host_scan:
            log.info("SNP QC: host-side %s scan (qc_mode=%s).",
                     "packed" if sample_sel is None else "decoded-subset",
                     config.qc_mode)
            local = _qc_snp_range_hostscan(bed, config, n_qc, lo, hi,
                                           sample_sel=sample_sel)
        else:
            device = _resolve_device(device)
            if config.fuse_qc_matrix and (world == 1 or config.distributed_qc):
                max_rows = (bed.n_snps if scan_ranges is None
                            or not config.distributed_qc
                            else max(h - l for l, h in scan_ranges))
                capture = _capture_if_fits(max_rows, n_qc, packed, device)
            log.info("SNP QC: device %s scan on %s (qc_mode=%s).",
                     "packed" if packed else "int8", device, config.qc_mode)
            local = _qc_snp_range(bed, config, sample_sel, n_qc, lo, hi, device,
                                  capture=capture, packed=packed)
        if scan_ranges is not None and config.distributed_qc:
            keep, mean_all, std_all = _allgather_qc(*local, scan_ranges)
        else:
            keep, mean_all, std_all = local
    qc_orig = np.nonzero(keep)[0]
    log.info("SNP QC: %d / %d SNPs passed.", len(qc_orig), bed.n_snps)

    with span("gp.prepare.ld_map") as mapped:
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
        # Several ranks: the decision was the same on every rank, so a
        # rank whose range held no batch keeps its capture too.
        qc_capture=capture if capture is not None and (capture.batches or world > 1)
        else None,
        stage_seconds={"open": opened.seconds, "qc_scan": scanned.seconds,
                       "ld_map": parsed.seconds + mapped.seconds},
    )

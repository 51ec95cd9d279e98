"""Per-SNP QC: genotype counts on the device or the host, and the exact
filter chain.

Copies of the numpy parts of `genomic_pca_tpu/ops/qc.py` (the reference
module also holds jax reductions, and its package imports jax):
`genotype_counts_packed_host`, `genotype_counts_int8_host`,
`dosage_mean_from_counts`, `QcResult` and `snp_qc_from_counts`, pinned
bit-equal to them by tests/test_torch_sharded.py and
tests/test_torch_prepare.py; and the device counts of its jitted
reductions, `genotype_counts` (int8 rows), `genotype_counts_packed`
(PLINK 2-bit rows) and `qc_strip`, as plain PyTorch on the tensor's own
device (tests/test_torch_qcscan.py holds them to the JAX functions).
Counts are exact integers, so every QC decision and moment follows from
them without floating-point accumulation error.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.ops.hwe import hwe_chi2_p

# counts-per-byte of each 2-bit code: _PACKED_CODE_COUNT[code][byte]
_PACKED_CODE_COUNT = np.zeros((4, 256), dtype=np.uint8)
for _b in range(256):
    for _p in range(4):
        _PACKED_CODE_COUNT[(_b >> (2 * _p)) & 3, _b] += 1


def genotype_counts(strip: torch.Tensor) -> tuple:
    """int32 (n0, n1, n2, n_valid), each (snps,), of an int8 (snps,
    samples) strip, on its device; any value outside {0, 1, 2} counts as
    missing."""
    n0 = (strip == 0).sum(dim=1, dtype=torch.int32)
    n1 = (strip == 1).sum(dim=1, dtype=torch.int32)
    n2 = (strip == 2).sum(dim=1, dtype=torch.int32)
    return n0, n1, n2, n0 + n1 + n2


def genotype_counts_packed(strip: torch.Tensor, n_samples: int) -> tuple:
    """`genotype_counts` of a PLINK 2-bit (snps, bytes) uint8 strip.

    Codes (count_A1, low bits first): 00 -> dosage 2, 01 -> missing,
    10 -> 1, 11 -> 0.  Fields of sample index `n_samples` and beyond (the
    last data byte's trailing fields and the pad columns) are masked out,
    as the JAX function masks them."""
    n4 = strip.shape[1]
    cols = torch.arange(n4, device=strip.device)
    n0 = torch.zeros(strip.shape[0], dtype=torch.int32, device=strip.device)
    n1 = torch.zeros_like(n0)
    n2 = torch.zeros_like(n0)
    for p in range(4):
        cp = (strip >> (2 * p)) & 3
        valid = (4 * cols + p < n_samples)[None, :]
        n2 += ((cp == 0) & valid).sum(dim=1, dtype=torch.int32)
        n1 += ((cp == 2) & valid).sum(dim=1, dtype=torch.int32)
        n0 += ((cp == 3) & valid).sum(dim=1, dtype=torch.int32)
    return n0, n1, n2, n0 + n1 + n2


def genotype_counts_packed_host(raw: np.ndarray, n_samples: int) -> np.ndarray:
    """(rows, 4) int32 (n0, n1, n2, n_valid) of raw PLINK rows (rows,
    >= ceil(n_samples / 4)) uint8; pad columns and trailing pad fields
    are not samples.  The same integers as the native
    `plinkio_packed_qc_counts`."""
    bps = (n_samples + 3) // 4
    raw = np.asarray(raw, dtype=np.uint8)[:, :bps]
    n0 = _PACKED_CODE_COUNT[3][raw].sum(axis=1, dtype=np.int64)
    n1 = _PACKED_CODE_COUNT[2][raw].sum(axis=1, dtype=np.int64)
    miss = _PACKED_CODE_COUNT[1][raw].sum(axis=1, dtype=np.int64)
    rem = n_samples % 4
    if rem and bps:
        last = raw[:, -1]
        for p in range(rem, 4):  # trailing pad fields are not samples
            code = (last >> (2 * p)) & 3
            n0 -= code == 3
            n1 -= code == 2
            miss -= code == 1
    nv = n_samples - miss
    n2 = nv - n0 - n1
    return np.stack([n0, n1, n2, nv], axis=1).astype(np.int32)


def dosage_mean_from_counts(counts: np.ndarray) -> np.ndarray:
    """Exact per-SNP dosage mean over valid entries from (rows, 4)
    integer counts (n0, n1, n2, n_valid)."""
    nv = counts[:, 3].astype(np.int64)
    ds = counts[:, 1].astype(np.int64) + 2 * counts[:, 2].astype(np.int64)
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.where(nv > 0, ds / np.maximum(nv, 1), 0.0)


def genotype_counts_int8_host(raw: np.ndarray) -> np.ndarray:
    """(rows, 4) int32 (n0, n1, n2, n_valid) of int8 dosage rows; any
    value outside {0, 1, 2} counts as missing."""
    raw = np.asarray(raw, dtype=np.int8)
    n0 = (raw == 0).sum(axis=1, dtype=np.int64)
    n1 = (raw == 1).sum(axis=1, dtype=np.int64)
    n2 = (raw == 2).sum(axis=1, dtype=np.int64)
    return np.stack([n0, n1, n2, n0 + n1 + n2], axis=1).astype(np.int32)


@dataclasses.dataclass
class QcResult:
    """Per-strip QC outcome: survivor mask plus standardization moments."""

    keep: np.ndarray  # bool (snps,)
    mean: np.ndarray  # float32 (snps,), 0 where dropped
    std: np.ndarray  # float32 (snps,), 0 where dropped

    @property
    def n_kept(self) -> int:
        return int(self.keep.sum())


def snp_qc_from_counts(
    n0: np.ndarray,
    n1: np.ndarray,
    n2: np.ndarray,
    n_valid: np.ndarray,
    n_qc_samples: int,
    config: DataPrepConfig,
) -> QcResult:
    """The QC chain in the reference tool's order, from integer counts:
    call rate >= min -> MAF >= min (+ monomorphic epsilon) -> HWE p > max
    (when max < 1) -> sample variance (ddof 1) > min_variance.  `n2` is
    the dosage-2 count; later filters run only on rows still alive."""
    n0 = np.asarray(n0, dtype=np.int64)
    n1 = np.asarray(n1, dtype=np.int64)
    n2 = np.asarray(n2, dtype=np.int64)
    nv = np.asarray(n_valid, dtype=np.int64)

    keep = np.ones(nv.shape, dtype=bool)
    if n_qc_samples > 0:
        call_rate = nv / float(n_qc_samples)
        keep &= call_rate >= config.min_call_rate
    keep &= nv > 0

    with np.errstate(divide="ignore", invalid="ignore"):
        dosage_sum = (n1 + 2 * n2).astype(np.float64)
        mean = np.where(nv > 0, dosage_sum / np.maximum(nv, 1), 0.0)
        freq = mean / 2.0
        maf = np.minimum(freq, 1.0 - freq)
        keep &= maf >= config.min_maf
        keep &= np.abs(freq) >= 1e-9
        keep &= np.abs(1.0 - freq) >= 1e-9
        alive = np.flatnonzero(keep)

        if config.max_hwe_p < 1.0 and len(alive):
            hwe_p = hwe_chi2_p(n0[alive], n1[alive], n2[alive])
            fail = hwe_p <= config.max_hwe_p
            keep[alive[fail]] = False
            alive = alive[~fail]

        # sample variance (ddof 1), exact: sum(g^2) = n1 + 4 n2
        nv_a = nv[alive]
        mean_a = mean[alive]
        sum_sq = (n1[alive] + 4 * n2[alive]).astype(np.float64)
        ssd = sum_sq - nv_a * mean_a * mean_a
        var_a = np.where(nv_a >= 2, ssd / np.maximum(nv_a - 1, 1), 0.0)
        fail = var_a <= config.min_variance
        keep[alive[fail]] = False
        alive = alive[~fail]
        var_a = var_a[~fail]

    mean_out = np.zeros(len(keep), dtype=np.float32)
    std_out = np.zeros(len(keep), dtype=np.float32)
    mean_out[alive] = mean[alive].astype(np.float32)
    std_out[alive] = np.sqrt(np.maximum(var_a, 0.0)).astype(np.float32)
    return QcResult(keep=keep, mean=mean_out, std=std_out)


def qc_strip(strip: torch.Tensor, n_qc_samples: int,
             config: DataPrepConfig) -> QcResult:
    """The QC of one int8 strip: device counts, then the host filter."""
    n0, n1, n2, nv = (c.cpu().numpy() for c in genotype_counts(strip))
    return snp_qc_from_counts(n0, n1, n2, nv, n_qc_samples, config)

"""Exact Gram-matrix PCA, the correctness oracle, on the port.

Counterpart of `genomic_pca_tpu/models/exact.py`: stream variant strips,
QC them on the host from exact integer counts, mean-impute missing
genotypes, centre (optionally scale), accumulate the N x N sample Gram
matrix in float64, divide by the kept-variant count, run an exact `eigh`,
and return scores = eigenvectors * sqrt(eigenvalues).

The Gram and the eigensolve run in float64 on `device` (the card unless
the caller asks for the CPU): each kept strip is uploaded as int8 and
standardized there.  It is the measuring stick the fast paths are held
to (sign-invariant per-PC |r|), not a production path.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.errors import ComputeError
from genomic_pca_tpu_torch.ops.qc import genotype_counts_int8_host, snp_qc_from_counts
from genomic_pca_tpu_torch.ops.standardize import MISSING


@dataclasses.dataclass
class ExactPcaResult:
    scores: np.ndarray  # (n_samples, k)
    eigenvalues: np.ndarray  # (k,)
    n_kept_variants: int


def exact_pca_from_strips(
    strips: Iterable[np.ndarray],
    n_samples: int,
    k: int,
    config: Optional[DataPrepConfig] = None,
    scale: bool = False,
    apply_qc: bool = True,
    device="cuda",
) -> ExactPcaResult:
    """Exact PCA over an iterator of (snps, samples) int8 dosage strips.

    `scale=False` is the reference oracle (centre only); `scale=True`
    standardizes like the EigenSNP path.  The (N, N) float64 Gram lives
    on `device`: 8 N^2 bytes (50 MB at 2,504 samples, 2 GiB at 16,384)."""
    config = config or DataPrepConfig()
    dev = torch.device(device)
    gram = torch.zeros((n_samples, n_samples), dtype=torch.float64, device=dev)
    kept = 0

    for strip in strips:
        strip = np.asarray(strip, dtype=np.int8)
        n0, n1, n2, nv = genotype_counts_int8_host(strip).T
        if apply_qc:
            qc = snp_qc_from_counts(n0, n1, n2, nv, n_samples, config)
            if qc.n_kept == 0:
                continue
            sel = strip[qc.keep]
            mean = qc.mean[qc.keep].astype(np.float64)
            std = qc.std[qc.keep].astype(np.float64)
        else:
            with np.errstate(divide="ignore", invalid="ignore"):
                mean = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
                ssd = (n1 + 4.0 * n2) - nv * mean * mean
                std = np.sqrt(np.where(nv >= 2, ssd / np.maximum(nv - 1, 1), 0.0))
            sel = strip

        g = torch.from_numpy(np.ascontiguousarray(sel)).to(dev)
        m = torch.from_numpy(mean).to(dev)[:, None]
        # Impute first, then centre: a missing entry becomes exactly 0.
        x = torch.where(g != MISSING, g.to(torch.float64), m) - m
        if scale:
            s = torch.from_numpy(std).to(dev)
            x /= torch.where(s > 0, s, torch.ones_like(s))[:, None]
        gram.addmm_(x.T, x)
        kept += x.shape[0]

    if kept == 0:
        raise ComputeError("No variants passed QC; cannot compute PCA.")

    gram /= kept
    evals_all, evecs_all = torch.linalg.eigh(gram)  # ascending
    k_eff = min(k, n_samples - 1) if n_samples > 1 else 1
    evals = evals_all[-k_eff:].flip(0)
    evecs = evecs_all[:, -k_eff:].flip(1)
    scores = evecs * torch.sqrt(torch.clamp(evals, min=0.0))
    return ExactPcaResult(scores=scores.cpu().numpy(),
                          eigenvalues=evals.cpu().numpy(),
                          n_kept_variants=kept)

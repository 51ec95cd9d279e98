"""The SNP QC rules of the EigenSNP workflow, on exact integer counts.

In order, each on the SNPs still kept: call rate >= `min_call_rate`;
minor allele frequency >= `min_maf`, and neither allele frequency within
1e-9 of 0; Hardy-Weinberg p-value > `max_hwe_p` (Pearson chi-squared
with one degree of freedom on the three genotype counts, p = erfc(sqrt(
chi2 / 2)); a p of 1 where an allele frequency is below 1e-9; an
expected count at or below 1e-9 with an observed one above it gives
p = 0); sample variance (ddof 1) > `min_variance`.
"""

from __future__ import annotations

import numpy as np
from scipy.special import erfc


def hwe_p(n0: np.ndarray, n1: np.ndarray, n2: np.ndarray) -> np.ndarray:
    n0, n1, n2 = (np.asarray(x, np.float64) for x in (n0, n1, n2))
    n = n0 + n1 + n2
    alleles = 2 * n
    with np.errstate(divide="ignore", invalid="ignore"):
        p = (2 * n2 + n1) / alleles
        q = 1 - p
        chi2 = np.zeros_like(n)
        zero_expected = np.zeros(n.shape, bool)
        for obs, exp in ((n2, p * p * n), (n1, 2 * p * q * n), (n0, q * q * n)):
            ok = exp > 1e-9
            chi2 += np.where(ok, (obs - exp) ** 2 / np.where(ok, exp, 1), 0)
            zero_expected |= ~ok & (obs > 1e-9)
        out = erfc(np.sqrt(np.maximum(chi2, 0) / 2))
    out = np.where(zero_expected, 0.0, out)
    return np.where((n <= 0) | (p < 1e-9) | (q < 1e-9), 1.0, out)


def snp_qc(cnt: np.ndarray, n_samples: int, rules: dict):
    """(keep bool, mean f64, std f64) of (D, 4) counts (n0, n1, n2,
    valid); mean and std are those of the kept SNPs (0 elsewhere)."""
    cnt = np.asarray(cnt, np.int64)
    n0, n1, n2, nv = cnt.T
    keep = (nv / float(n_samples) >= rules["min_call_rate"]) & (nv > 0)
    with np.errstate(divide="ignore", invalid="ignore"):
        mean = np.where(nv > 0, (n1 + 2.0 * n2) / np.maximum(nv, 1), 0.0)
        freq = mean / 2
        keep &= np.minimum(freq, 1 - freq) >= rules["min_maf"]
        keep &= (np.abs(freq) >= 1e-9) & (np.abs(1 - freq) >= 1e-9)
        if rules["max_hwe_p"] < 1.0:
            alive = np.flatnonzero(keep)
            keep[alive[hwe_p(n0[alive], n1[alive], n2[alive]) <= rules["max_hwe_p"]]] = False
        ss = n0 * mean**2 + n1 * (1 - mean) ** 2 + n2 * (2 - mean) ** 2
        var = np.where(nv >= 2, ss / np.maximum(nv - 1, 1), 0.0)
    keep &= var > rules["min_variance"]
    return keep, np.where(keep, mean, 0.0), np.where(keep, np.sqrt(np.maximum(var, 0)), 0.0)

"""Hardy-Weinberg equilibrium chi-squared test (1 d.o.f.), vectorized.

A copy of `genomic_pca_tpu/ops/hwe.py` (the JAX package's
`ops/__init__.py` imports jax).  Numerically mirrors
`calculate_hwe_chi_squared_p_value` of the reference Rust tool
(`src/prepare.rs:1641-1745`) including its edge cases:

* zero genotyped samples -> p = 1.0
* effectively-monomorphic (allele freq < 1e-9) -> p = 1.0
* expected count ~0 with observed > 0 -> chi2 = inf -> p = 0.0
* NaN statistic -> p = 1.0
* otherwise p = max(1 - CDF_chi2_1(stat), 0)

For df=1, the survival function has the closed form
``P(X > x) = erfc(sqrt(x / 2))`` which is what we evaluate (exactly the
`1 - ChiSquared::new(1.0).cdf(stat)` of the reference, statrs-based).

The HWE statistic is symmetric under swapping the two homozygote counts,
so A1/A2 counting conventions don't change the p-value.
"""

from __future__ import annotations

import numpy as np

try:  # scipy is present in both images
    from scipy.special import erfc as _erfc
except Exception:  # pragma: no cover - fallback for minimal envs
    import math

    _erfc = np.vectorize(math.erfc, otypes=[np.float64])

_MIN_EXPECTED = 1e-9
_FREQ_EPSILON = 1e-9


def hwe_chi2_p(
    n_hom_a: np.ndarray, n_het: np.ndarray, n_hom_b: np.ndarray
) -> np.ndarray:
    """Vectorized HWE p-values from per-SNP genotype counts."""
    n_hom_a = np.asarray(n_hom_a, dtype=np.float64)
    n_het = np.asarray(n_het, dtype=np.float64)
    n_hom_b = np.asarray(n_hom_b, dtype=np.float64)

    n = n_hom_a + n_het + n_hom_b
    count_a = 2.0 * n_hom_a + n_het
    count_b = 2.0 * n_hom_b + n_het
    total_alleles = count_a + count_b

    with np.errstate(divide="ignore", invalid="ignore"):
        p = count_a / total_alleles
        q = count_b / total_alleles

        exp_aa = p * p * n
        exp_ab = 2.0 * p * q * n
        exp_bb = q * q * n

        chi2 = np.zeros_like(n)
        inf_mask = np.zeros_like(n, dtype=bool)
        for obs, exp in ((n_hom_a, exp_aa), (n_het, exp_ab), (n_hom_b, exp_bb)):
            term_ok = exp > _MIN_EXPECTED
            term = np.where(term_ok, (obs - exp) ** 2 / np.where(term_ok, exp, 1.0), 0.0)
            chi2 = chi2 + term
            inf_mask |= (~term_ok) & (obs > _MIN_EXPECTED)

        pval = np.maximum(_erfc(np.sqrt(np.maximum(chi2, 0.0) / 2.0)), 0.0)

    pval = np.where(inf_mask, 0.0, pval)
    pval = np.where(np.isnan(chi2), 1.0, pval)
    # Monomorphic / degenerate-frequency cases -> 1.0 (prepare.rs:1666-1671)
    degenerate = (
        (n <= 0)
        | (total_alleles <= _MIN_EXPECTED)
        | (p < _FREQ_EPSILON)
        | (q < _FREQ_EPSILON)
    )
    return np.where(degenerate, 1.0, pval)

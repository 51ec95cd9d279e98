"""The port's float64 oracle `models/exact.py` against the JAX package's,
on the CPU.

The cases of tests/test_exact.py, each with and without scaling and QC,
through `exact_pca_from_strips(..., device="cpu")` and the JAX function
on the same seeded strips: eigenvalues at rtol 1e-10, scores equal up to
each column's sign at atol 1e-9, the same kept-variant count.
"""

import numpy as np
import pytest

from genomic_pca_tpu.config import DataPrepConfig as JConfig
from genomic_pca_tpu.models.exact import exact_pca_from_strips as jax_exact
from genomic_pca_tpu_torch.config import DataPrepConfig
from genomic_pca_tpu_torch.models.exact import exact_pca_from_strips
from tests.conftest import make_genotypes

OPEN = dict(min_call_rate=0.0, min_maf=0.0, max_hwe_p=1.0)

# name: (snps, samples, missing, strip rows, k, QC config kwargs or None)
CASES = {
    "direct_eigh": (300, 40, 0.0, 64, 5, OPEN),
    "ragged_strips": (257, 30, 0.02, 17, 4, None),
    "k_clamped": (100, 10, 0.01, 50, 50, None),
    "standardizes": (400, 32, 0.01, 100, 3, OPEN),
}


def _strips(geno, size):
    for s in range(0, geno.shape[0], size):
        yield geno[s : s + size]


@pytest.mark.parametrize("apply_qc", [True, False])
@pytest.mark.parametrize("scale", [False, True])
@pytest.mark.parametrize("case", list(CASES))
def test_exact_matches_reference(rng, case, scale, apply_qc):
    d, n, missing, size, k, cfg = CASES[case]
    geno = make_genotypes(rng, d, n, missing_rate=missing)
    kw = dict(scale=scale, apply_qc=apply_qc)
    got = exact_pca_from_strips(
        _strips(geno, size), n, k=k,
        config=DataPrepConfig(**cfg) if cfg else None, device="cpu", **kw)
    ref = jax_exact(_strips(geno, size), n, k=k,
                    config=JConfig(**cfg) if cfg else None, **kw)
    assert got.n_kept_variants == ref.n_kept_variants
    assert got.scores.shape == ref.scores.shape == (n, min(k, n - 1))
    assert got.scores.dtype == got.eigenvalues.dtype == np.float64
    np.testing.assert_allclose(got.eigenvalues, ref.eigenvalues, rtol=1e-10)
    signs = np.sign((got.scores * ref.scores).sum(axis=0))
    np.testing.assert_allclose(got.scores * signs, ref.scores, rtol=0, atol=1e-9)


@pytest.mark.parametrize("scale", [False, True])
def test_no_survivors_raises_as_reference(scale):
    geno = np.zeros((20, 10), dtype=np.int8)  # all monomorphic
    from genomic_pca_tpu_torch.errors import ComputeError

    with pytest.raises(ComputeError, match="No variants passed QC"):
        exact_pca_from_strips(_strips(geno, 10), 10, k=3, scale=scale, device="cpu")
    with pytest.raises(ValueError, match="No variants passed QC"):
        jax_exact(_strips(geno, 10), 10, k=3, scale=scale)

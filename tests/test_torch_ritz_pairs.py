"""The resident container's PCA core against the float64 eigendecomposition
of the data: every reported eigenvalue is its vector's Rayleigh quotient
and lies under the data's eigenvalue of its rank, on a cohort wide enough
in samples that the passes' error along the ones vector reaches the bulk
of the spectrum; and `COUNTS["passes_2d"]`, the passes of the 2-D mode.

The cohort: 2,048 SNPs (1,773 past a MAF filter) x 20,000 samples, five
Balding-Nichols populations at Fst 0.06 with the shares of a biobank of
one dominant ancestry (94%, 2.5%, 2%, 1%, 0.5%), 0.5% of the calls
missing.  The ancestral allele frequencies lie on 0.85-0.99, so that
mean / std of each row is large: bf16 rounds each row's shift by up to
half a step of it, and the bf16 operator takes an eigenvalue of 0.38
along the ones vector (the q8 passes add their own), against a bulk of
1.65.  A core whose basis is not held orthogonal to the ones vector
(`ops/rsvd.centre_samples`) reports here eigenvalues 0.9-8.4% away from
their vectors' Rayleigh quotients.
"""

import numpy as np
import pytest
import torch

from genomic_pca_tpu_torch.models.pca import pca_core
from genomic_pca_tpu_torch.ops.rsvd import centre_samples
from genomic_pca_tpu_torch.parallel import sharded as ts
from genomic_pca_tpu_torch.utils import profiling

SHARES = (0.94, 0.025, 0.02, 0.01, 0.005)
D, N, K, ELL = 2048, 20_000, 10, 128
MISSING = 0.005
SEED = 2147484100
# A Ritz value and its vector's Rayleigh quotient under the data: the
# passes' bf16 operands leave them about 2^-9 apart at most.
RQ_RTOL = 2e-3


def biobank_cohort(seed: int):
    """(packed rows, mean, std, float64 standardized rows) of the kept SNPs
    (MAF >= 0.01, nonzero variance)."""
    rng = np.random.default_rng(seed)
    anc = rng.uniform(0.85, 0.99, size=D)
    fst = 0.06
    a = anc * (1 - fst) / fst
    b = (1 - anc) * (1 - fst) / fst
    freqs = rng.beta(a[:, None].repeat(len(SHARES), 1), b[:, None].repeat(len(SHARES), 1))
    edges = np.rint(np.concatenate([[0.0], np.cumsum(SHARES)]) * N).astype(np.int64)
    pop = np.repeat(np.arange(len(SHARES)), np.diff(edges))
    f = freqs[:, pop]
    g = ((rng.random((D, N)) < f).astype(np.int8) + (rng.random((D, N)) < f)).astype(np.int8)
    g[rng.random((D, N)) < MISSING] = -127
    valid = g != -127
    nv = valid.sum(1)
    g0 = np.where(valid, g, 0).astype(np.float64)
    mean = g0.sum(1) / nv
    std = np.sqrt(((g0 - mean[:, None]) ** 2 * valid).sum(1) / (nv - 1))
    keep = (std > 0) & (np.minimum(mean, 2 - mean) / 2 >= 0.01)
    g, valid, mean, std = g[keep], valid[keep], mean[keep], std[keep]
    x = np.where(valid, (g - mean[:, None]) / std[:, None], 0.0)
    return ts.pack_int8_rows(g), mean.astype(np.float32), std.astype(np.float32), x


@pytest.fixture(scope="module")
def cohort():
    packed, mean, std, x = biobank_cohort(SEED)
    evals = np.linalg.eigvalsh(x @ x.T)[::-1] / (N - 1)
    return packed, mean, std, x, evals


@pytest.mark.parametrize("mode,precision,n_iter", [
    ("2d", "q8", 4),   # three int8 steering passes and the exact polish
    ("2d", "q8", 3),
    ("1d", "q8", 4),
    ("2d", "bf16", 4),
])
def test_pca_core_reports_ritz_pairs_of_the_data(cohort, mode, precision, n_iter):
    packed, mean, std, x, data_evals = cohort
    sm = ts.ShardedMatrix.from_packed_rows(packed, mean, std, N, "cpu", mode=mode,
                                           kernel_precision=precision,
                                           missing_fraction=MISSING)
    assert sm.mode == mode
    b0 = torch.from_numpy(np.random.default_rng(SEED).standard_normal(
        (N, ELL)).astype(np.float32))
    v, _, evals, _, _ = pca_core(sm, b0, n_iter, K)
    v = v.numpy().astype(np.float64)
    got = evals.numpy().astype(np.float64) / (N - 1)
    xv = x @ v
    rayleigh = (xv * xv).sum(0) / (N - 1)
    np.testing.assert_allclose(got, rayleigh, rtol=RQ_RTOL)
    # Ritz values of the data lie under its eigenvalues, rank by rank;
    # the two leading PCs, far above the bulk, are found.
    assert (got <= data_evals[:K] * (1 + RQ_RTOL)).all(), (got, data_evals[:K])
    np.testing.assert_allclose(got[:2], data_evals[:2], rtol=1e-3)
    # The scores are orthogonal to the ones vector, as the data's PCs are.
    assert np.abs(v.sum(0)).max() / np.sqrt(N) < 1e-4


def test_centre_samples_takes_out_the_mean_of_the_real_samples():
    t = torch.arange(24, dtype=torch.float32).reshape(6, 4) ** 2
    got = centre_samples(t, 4)
    assert torch.equal(got[4:], torch.zeros(2, 4))
    torch.testing.assert_close(got[:4].sum(0), torch.zeros(4), atol=1e-4, rtol=0)
    torch.testing.assert_close(got[:4], t[:4] - t[:4].mean(0), atol=0, rtol=0)
    # A column already orthogonal to the ones vector stays as it was.
    col = torch.tensor([[1.0], [-2.0], [3.0], [-2.0], [7.0]])
    assert torch.equal(centre_samples(col, 4)[:4], col[:4])


def _small(mode, precision="q8"):
    rng = np.random.default_rng(5)
    g = rng.integers(0, 3, size=(96, 300)).astype(np.int8)
    g[rng.random(g.shape) < 0.01] = -127
    mean, std = ts.host_moments(g)
    return ts.ShardedMatrix.from_packed_rows(ts.pack_int8_rows(g), mean, std, 300,
                                             "cpu", mode=mode,
                                             kernel_precision=precision)


@pytest.mark.parametrize("n_iter,precision,passes", [
    (4, "q8", 6),    # 3 q8 passes, the exact polish, the Rayleigh-Ritz Gram, the loadings
    (1, "q8", 3),    # the exact polish alone
    (2, "bf16", 4),
])
def test_passes_2d_counts_each_pass_of_the_2d_mode(n_iter, precision, passes):
    sm = _small("2d", precision)
    b0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (300, 16)).astype(np.float32))
    profiling.reset_counts()
    pca_core(sm, b0, n_iter, 4)
    assert profiling.COUNTS["passes_2d"] == passes
    # The public passes count one each; the Gram's right product is part
    # of it.
    sm.gram_apply(b0)
    sm.tsq_accumulate(b0)
    sm.right_apply(b0)
    assert profiling.COUNTS["passes_2d"] == passes + 3
    profiling.reset_counts()
    assert "passes_2d" not in profiling.COUNTS


def test_passes_2d_stays_out_in_the_1d_mode():
    sm = _small("1d")
    profiling.reset_counts()
    b0 = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (300, 16)).astype(np.float32))
    pca_core(sm, b0, 4, 4)
    sm.gram_apply(b0)
    assert profiling.COUNTS.get("passes_2d", 0) == 0
    assert set(profiling.COUNTS) == {"d2h_bytes", "table_rows_native",
                                     "table_rows_loop"}

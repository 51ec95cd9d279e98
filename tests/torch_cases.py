"""Jax-free inputs and references shared by the port's tests.

tests/test_torch_cuda.py runs on a machine without jax, so nothing here
may import it (nor tests/conftest.py, which does).
"""

import numpy as np

from genomic_pca_tpu_torch.parallel.sharded import (
    PACKED_MISSING_BYTE, pack_int8_rows, packed_cols,
)


def balding_nichols(rng, n_snps, n_samples, missing_rate=0.0, n_pops=3,
                    fst=0.1):
    """Structured dosages (n_snps, n_samples) int8, -127 missing: the
    model of tests/conftest.py make_genotypes, so PCs separate."""
    ancestral = rng.uniform(0.1, 0.9, size=n_snps)
    a = ancestral * (1 - fst) / fst
    b = (1 - ancestral) * (1 - fst) / fst
    pop_freqs = rng.beta(a[:, None], b[:, None], size=(n_snps, n_pops))
    pop_of = rng.integers(0, n_pops, size=n_samples)
    geno = rng.binomial(2, pop_freqs[:, pop_of]).astype(np.int8)
    if missing_rate > 0:
        mask = rng.random((n_snps, n_samples)) < missing_rate
        geno = np.where(mask, np.int8(-127), geno)
    return geno


def padded_packed(geno):
    """Packed rows padded to `packed_cols` bytes with 0x55."""
    d, n = geno.shape
    out = np.full((d, packed_cols(n)), PACKED_MISSING_BYTE, np.uint8)
    p = pack_int8_rows(geno)
    out[:, : p.shape[1]] = p
    return out


def exact_case(rng, d=96, n=250, ell=128):
    """(packed, mean (d,1), inv_std (d,1), b) with missing genotypes, an
    inert row, sample padding and an orthonormal-scale basis whose padded
    rows are zero - the inputs the power loop feeds the exact kernels."""
    geno = balding_nichols(rng, d, n, missing_rate=0.05)
    packed = padded_packed(geno)
    valid = geno != -127
    g0 = np.where(valid, geno, 0).astype(np.float64)
    mu = (g0.sum(1) / valid.sum(1)).astype(np.float32)
    inv = (1.0 / (g0.std(1) + 0.1)).astype(np.float32)
    inv[5] = 0.0
    n_pad = packed.shape[1] * 4
    b = (rng.standard_normal((n_pad, ell)) / np.sqrt(n)).astype(np.float32)
    b[n:] = 0.0
    return packed, mu[:, None], inv[:, None], b


def dense_case(rng, d=512, n=256, ell=128):
    """(geno int8 (d, n), mean (d,1), inv_std (d,1), b (n, L)) with 5%
    missing genotypes (-127) and an inert row: the exact dense kernels'
    inputs."""
    geno = balding_nichols(rng, d, n, missing_rate=0.05)
    valid = geno != -127
    g0 = np.where(valid, geno, 0).astype(np.float64)
    mu = (g0.sum(1) / valid.sum(1)).astype(np.float32)
    inv = (1.0 / (g0.std(1) + 0.1)).astype(np.float32)
    inv[5] = 0.0
    b = (rng.standard_normal((n, ell)) / np.sqrt(n)).astype(np.float32)
    return geno, mu[:, None], inv[:, None], b


def q8_case(rng, d, n, ell, missing_rate=0.02):
    """Inputs of one q8 pass: (geno, inv_std, u, bq, sb (1,1), csum (1,L))."""
    g = balding_nichols(rng, d, n, missing_rate=missing_rate)
    iv = rng.uniform(0.5, 2.0, (d, 1)).astype(np.float32)
    u = rng.uniform(0.0, 2.0, (d, 1)).astype(np.float32)
    b = rng.standard_normal((n, ell)).astype(np.float32)
    sb = np.float32(np.abs(b).max() / 127.0)
    bq = np.clip(np.round(b / sb), -127, 127).astype(np.int8)
    csum = (bq.astype(np.float32).sum(axis=0) * sb)[None, :]
    return g, iv, u, bq, np.full((1, 1), sb, np.float32), csum


def quant_model(g, iv, u, bq, sb, tile_d):
    """Float64 replay of the q8 quantization model (tests/test_q8.py)."""
    g0 = np.maximum(g, 0).astype(np.float64)
    y = (iv * g0 - u) @ (bq.astype(np.float64) * sb)
    t = np.zeros((g.shape[1], bq.shape[1]))
    for lo in range(0, g.shape[0], tile_d):
        z = iv[lo : lo + tile_d] * y[lo : lo + tile_d]
        sz = np.abs(z).max() / 127.0 + 1e-30
        z8 = np.clip(np.round(z / sz), -127, 127)
        t += g0[lo : lo + tile_d].T @ z8 * sz
    return t - (u * y).sum(axis=0)[None, :]


def exact_pcs(g, k):
    """Float64 PCA of standardized dosages (missing -> 0): the top-k
    eigenvectors of A^T A and eigenvalues, descending."""
    valid = g != -127
    g0 = np.where(valid, g, 0).astype(np.float64)
    cnt = valid.sum(axis=1)
    mean = g0.sum(axis=1) / cnt
    ssd = (((g0 - mean[:, None]) ** 2) * valid).sum(axis=1)
    std = np.sqrt(ssd / (cnt - 1))
    inv = np.where(std > 0, 1.0 / np.where(std > 0, std, 1.0), 0.0)
    a = np.where(valid, (g0 - mean[:, None]) * inv[:, None], 0.0)
    evals, evecs = np.linalg.eigh(a.T @ a)
    return evecs[:, ::-1][:, :k], evals[::-1][:k], mean, std


def abs_corr(x, y):
    x = x - x.mean()
    y = y - y.mean()
    return abs(float(x @ y / (np.linalg.norm(x) * np.linalg.norm(y))))

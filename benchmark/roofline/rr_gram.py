"""The Rayleigh-Ritz Gram, (A Q)^T (A Q): the product A Q and the (L, L)
Gram of its rows, at the bf16 peak; the genotypes, Q and the (L, L)
result."""


def work(d, n, ell, k):
    return (2 * d * n * ell + 2 * d * ell * ell,
            d * (-(-n // 4)) + 4 * n * ell + 4 * ell * ell, "bf16_ops_per_s")

"""The loadings, A V_k: one product of k columns at the bf16 peak; the
genotypes, V_k and the (d, k) result."""


def work(d, n, ell, k):
    return 2 * d * n * k, d * (-(-n // 4)) + 4 * n * k + 4 * d * k, "bf16_ops_per_s"

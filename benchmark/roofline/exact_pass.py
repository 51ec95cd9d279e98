"""An exact power pass, A^T (A B): two products at the bf16 peak; the
genotypes, B and the (n, L) result."""


def work(d, n, ell, k):
    return 4 * d * n * ell, d * (-(-n // 4)) + 2 * 4 * n * ell, "bf16_ops_per_s"

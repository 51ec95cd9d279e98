"""A quantized steering pass, A^T (A B) with B in int8: two products at
the int8 peak; the genotypes, B and the (n, L) result."""


def work(d, n, ell, k):
    return 4 * d * n * ell, d * (-(-n // 4)) + 2 * 4 * n * ell, "int8_ops_per_s"

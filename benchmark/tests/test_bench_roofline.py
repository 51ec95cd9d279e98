"""The roofline's work counts against hand arithmetic."""

import pytest

from benchmark import roofline

PASSES = {"q8_pass": [["q8_pass", 1]]}


def test_q8_pass_bound_is_kernel_1s():
    # 262,144 x 2,048, L 128: 4 D N L = 2.749e11 int8 operations at
    # 1,979 TOP/s, 0.1389 ms; the bytes (134.2 MB of genotypes) take
    # 0.0407 ms.
    ms = 1e3 * roofline.pass_bound_s("q8_pass", 262_144, 2_048, 128, 10)
    assert ms == pytest.approx(4 * 262_144 * 2_048 * 128 / 1979e12 * 1e3, rel=1e-12)
    assert ms == pytest.approx(0.1389, abs=5e-5)


def test_memory_bound_pass():
    # One row of a very wide matrix at L 1: the bytes bound it.
    d, n = 1, 4_000_000
    s = roofline.pass_bound_s("exact_pass", d, n, 1, 1)
    assert s == pytest.approx((d * n // 4 + 2 * 4 * n) / 3.35e12, rel=1e-12)


def test_ukb_pca_job_bound():
    d, n, k, ell = 147_604, 407_219, 40, 50
    nb = d * (-(-n // 4))
    q8 = max(4 * d * n * ell / 1979e12, (nb + 8 * n * ell) / 3.35e12)
    exact = max(4 * d * n * ell / 989e12, (nb + 8 * n * ell) / 3.35e12)
    rr = max((2 * d * n * ell + 2 * d * ell * ell) / 989e12,
             (nb + 4 * n * ell + 4 * ell * ell) / 3.35e12)
    load = max(2 * d * n * k / 989e12, (nb + 4 * n * k + 4 * d * k) / 3.35e12)
    cfg = {"sizes": {"n_snps": d, "n_samples": n}, "pca": {"k": k, "n_oversamples": 10}}
    traffic = {"passes": [["q8_pass", 3], ["exact_pass", 1], ["rr_gram", 1],
                          ["loadings", 1]]}
    got = roofline.job_bound_ms(cfg, traffic)
    assert got == pytest.approx(1e3 * (3 * q8 + exact + rr + load), rel=1e-12)
    # Over four ranks each holds a quarter of the rows.
    quarter = roofline.job_bound_ms(cfg, traffic, world=4)
    assert quarter < got / 3

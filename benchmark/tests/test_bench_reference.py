"""The plain reference at a tiny size: decoding, QC, the two PCA solvers
against float64 `numpy.linalg.eigh`, and the comparison numbers."""

import hashlib

import numpy as np
import pytest
import torch

from benchmark import generate
from benchmark.reference import compare, decode, pca, qc

MODEL = {"kind": "balding_nichols", "n_pops": 4, "fst": 0.1, "size_ratio": 0.7,
         "ancestral_range": [0.1, 0.9], "missing": 0.01}


def _cohort(d=1500, n=203, seed=7):
    return generate.make_cohort(MODEL, d, n, seed, "cpu")


def _dense(cohort):
    """(D, N) float64 dosages with NaN for missing, by numpy."""
    codes = torch.cat([generate.strip_codes(cohort, lo, hi)
                       for lo, hi in cohort.strips()]).numpy()
    lut = np.array([2.0, np.nan, 1.0, 0.0])
    return lut[codes]


def test_pack_and_decode_round_trip():
    c = _cohort()
    for lo, hi in c.strips():
        code = generate.strip_codes(c, lo, hi)
        packed = generate.pack_codes(code)
        assert packed.shape == (hi - lo, -(-c.n_samples // 4))
        assert torch.equal(decode.codes(packed, c.n_samples), code)
        # The trailing fields of the last byte are missing (01).
        last = decode.codes(packed, 4 * packed.shape[1])[:, c.n_samples:]
        assert bool((last == 1).all())


def test_strips_are_reproducible():
    a, b = _cohort(seed=2**31 + 5), _cohort(seed=2**31 + 5)
    lo, hi = next(iter(a.strips()))
    assert torch.equal(generate.packed_strip(a, lo, hi), generate.packed_strip(b, lo, hi))
    c = _cohort(seed=2**31 + 6)
    assert not torch.equal(generate.packed_strip(a, lo, hi),
                           generate.packed_strip(c, lo, hi))


def test_size_ratio_cohort_bytes_unchanged():
    """A cohort of `size_ratio` draws the bytes and populations it drew
    before `shares` existed (digest of the packed rows and `pop_of`)."""
    c = _cohort(seed=2**31 + 5)
    h = hashlib.sha256()
    for lo, hi in c.strips():
        h.update(generate.packed_strip(c, lo, hi).numpy().tobytes())
    h.update(c.pop_of.numpy().astype("<i8").tobytes())
    assert h.hexdigest() == \
        "31f0b6720da8a656637f7009ea5c3fe7cb30a22c36ecfad996c4b712962e54d0"


def test_shares_come_out_as_stated():
    """At 407,219 samples each population holds its share, to within one
    sample, in order; shares that do not sum to 1 are refused."""
    shares = [0.94, 0.025, 0.02, 0.01, 0.005]
    model = dict(MODEL, n_pops=5, shares=shares)
    del model["size_ratio"]
    n = 407_219
    c = generate.make_cohort(model, 8, n, 2**31 + 77, "cpu")
    pop = c.pop_of.numpy()
    counts = np.bincount(pop, minlength=5)
    assert counts.sum() == n and len(counts) == 5
    assert np.abs(counts - n * np.array(shares)).max() <= 1
    assert (np.diff(pop) >= 0).all()
    # The frequency table is drawn as for `size_ratio`.
    ratio = generate.make_cohort(dict(MODEL, n_pops=5), 8, n, 2**31 + 77, "cpu")
    assert torch.equal(c.freqs, ratio.freqs)
    with pytest.raises(ValueError):
        generate.make_cohort(dict(model, shares=[0.5, 0.3, 0.1, 0.05, 0.01]), 8, n, 1,
                             "cpu")


def test_moments_match_numpy():
    c = _cohort()
    g = _dense(c)
    mean, std = generate.moments(c)
    np.testing.assert_allclose(mean, np.nanmean(g, 1), rtol=1e-6)
    np.testing.assert_allclose(std, np.nanstd(g, 1, ddof=1), rtol=1e-5)
    code = torch.cat([generate.strip_codes(c, lo, hi) for lo, hi in c.strips()])
    m2, s2 = decode.moments(decode.counts(code))
    np.testing.assert_allclose(m2.numpy(), np.nanmean(g, 1), rtol=1e-12)
    np.testing.assert_allclose(s2.numpy(), np.nanstd(g, 1, ddof=1), rtol=1e-10)


def test_hwe_p_known_values():
    # HWE holds exactly: p = 1; 100 / 0 / 100 homozygotes: chi2 = 200.
    p = qc.hwe_p(np.array([25, 100, 0]), np.array([50, 0, 0]), np.array([25, 100, 10]))
    assert p[0] == pytest.approx(1.0)
    from scipy.special import erfc
    assert p[1] == pytest.approx(erfc(np.sqrt(200 / 2)))
    assert p[2] == 1.0  # monomorphic


def test_snp_qc_rules():
    rules = {"min_call_rate": 0.98, "min_maf": 0.01, "max_hwe_p": 1e-6,
             "min_variance": 1e-9}
    n = 100
    cnt = np.array([
        [25, 50, 25, 100],   # kept
        [25, 50, 22, 97],    # call rate 0.97
        [100, 0, 0, 100],    # monomorphic
        [99, 1, 0, 100],     # MAF 0.005
        [50, 0, 50, 100],    # HWE fails
        [49, 50, 1, 100],    # kept
    ])
    keep, mean, std = qc.snp_qc(cnt, n, rules)
    assert keep.tolist() == [True, False, False, False, False, True]
    assert mean[0] == pytest.approx(1.0) and std[0] == pytest.approx(np.sqrt(50 / 99))


def _standardized_numpy(c):
    g = _dense(c)
    m, s = np.nanmean(g, 1), np.nanstd(g, 1, ddof=1)
    x = (g - m[:, None]) / s[:, None]
    return np.nan_to_num(x, nan=0.0)


def _blocks(c):
    code = [generate.strip_codes(c, lo, hi) for lo, hi in c.strips()]
    m, s = decode.moments(decode.counts(torch.cat(code)))

    def blocks():
        lo = 0
        for cd in code:
            r = cd.shape[0]
            yield decode.standardized(generate.pack_codes(cd), c.n_samples,
                                      m[lo:lo + r], s[lo:lo + r])
            lo += r
    return blocks


def test_gram_and_subspace_pca_against_numpy_eigh():
    c = _cohort()
    x = _standardized_numpy(c)
    ev, vec = np.linalg.eigh(x.T @ x)
    ev, vec = ev[::-1] / (c.n_samples - 1), vec[:, ::-1]
    v, e = pca.gram_pca(_blocks(c), c.n_samples, "cpu")
    np.testing.assert_allclose(e.numpy()[:10], ev[:10], rtol=1e-9)
    m = compare.separated_prefix(ev, 10)
    assert m >= 2
    assert compare.subspace_sin(v.numpy()[:, :m], vec[:, :m]) < 1e-9
    v2, e2 = pca.subspace_pca(_blocks(c), c.n_samples, 34, 30, 1, "cpu")
    np.testing.assert_allclose(e2.numpy()[:m], ev[:m], rtol=1e-6)
    assert compare.subspace_sin(v2.numpy()[:, :m], vec[:, :m]) < 1e-5
    u = pca.row_loadings(_blocks(c), v[:, :m])
    ref_u = x @ vec[:, :m]
    assert compare.subspace_sin(u, ref_u) < 1e-9


def test_rounded_subspace_pca_is_worse():
    c = _cohort()
    v, e = pca.gram_pca(_blocks(c), c.n_samples, "cpu")
    m = compare.separated_prefix(e.numpy(), 10)
    v8, e8 = pca.subspace_pca(_blocks(c), c.n_samples, 34, 30, 1, "cpu",
                              rounding=torch.float8_e4m3fn)
    assert compare.eval_err(e8.numpy(), e.numpy(), m) > 1e-4


def test_compare_numbers():
    rng = np.random.default_rng(0)
    a = np.linalg.qr(rng.standard_normal((50, 3)))[0]
    assert compare.subspace_sin(a, a @ np.diag([2.0, -1.0, 3.0])) < 1e-12
    b = a.copy()
    b[:, 2] = np.linalg.qr(np.c_[a, rng.standard_normal(50)])[0][:, 3]
    assert compare.subspace_sin(a, b) == pytest.approx(1.0)
    assert compare.separated_prefix(np.array([10.0, 9.0, 5.0, 4.9, 1.0]), 3) == 2
    assert compare.separated_prefix(np.array([10.0, 9.9, 9.8]), 2) == 0
    assert compare.eval_err(np.array([1.01, 2.0]), np.array([1.0, 2.0]), 2) == \
        pytest.approx(0.01)
    assert compare.worst([{"a": 1, "b": 3}, {"a": 2, "b": 1}]) == {"a": 2, "b": 3}


def test_ritz_sums_hold_every_pair_to_the_data():
    """Exact eigenpairs read 0 to rounding on every part of `ritz_err`;
    a wrong tail pair, a column dropped, and loadings off by 1% read
    what they are."""
    c = _cohort()
    x = _standardized_numpy(c)
    n, k = c.n_samples, 12
    ev, vec = np.linalg.eigh(x.T @ x)
    ev, vec = ev[::-1][:k] / (n - 1), vec[:, ::-1][:, :k]
    scores = vec * np.sqrt(ev * (n - 1))[None, :]
    loads = x @ vec / np.sqrt(ev * (n - 1))[None, :]
    swapped = ev.copy()
    swapped[[k - 2, k - 1]] = swapped[[k - 1, k - 2]]
    dropped = scores.copy()
    dropped[:, -1] = 0.0
    off = loads.copy()
    off[:, -1] *= 1.01
    jobs = [(scores, ev), (scores, swapped), (dropped, ev), (scores, ev)]
    sums = pca.ritz_sums(_blocks(c), jobs, n, "cpu",
                         loadings=[loads, loads, None, off])
    got = [compare.ritz_numbers(e, s) for (_, e), s in zip(jobs, sums)]
    assert got[0]["ritz_err"] < 1e-9 and set(got[0]) == {
        "ritz_pairs", "ritz_orth", "ritz_load", "ritz_err"}
    # Swapped, the pair scales V by sigma_j / sigma'_j: V^T C V reads
    # lambda_j^2 / lambda'_j against lambda'_j.
    assert got[1]["ritz_pairs"] == pytest.approx((ev[k - 2] / ev[k - 1]) ** 2 - 1,
                                                 rel=1e-6)
    assert got[2]["ritz_err"] == pytest.approx(1.0) and "ritz_load" not in got[2]
    assert got[3]["ritz_load"] == pytest.approx(0.01, rel=1e-6)
    # One column a pass: the same sums, chunk by chunk.
    orig = pca.RITZ_COLS
    try:
        pca.RITZ_COLS = 1
        again = pca.ritz_sums(_blocks(c), jobs[:2], n, "cpu")
    finally:
        pca.RITZ_COLS = orig
    np.testing.assert_allclose(again[1]["h"], sums[1]["h"], rtol=1e-12, atol=1e-9)
    assert compare.ritz_numbers(ev, {"h": np.full((k, k), np.nan),
                                     "vtv": np.eye(k)})["ritz_err"] == float("inf")

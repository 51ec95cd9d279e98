"""The numbers that decide `correct`, each compared with its limit.

PCs are compared over the leading `m` of them: `m` is the largest j <=
k at which the reference's spectrum falls by a factor of at least 1 +
`GAP` (lambda_j >= (1 + GAP) lambda_{j+1}), so that the compared PCs
span a subspace the data defines; the PCs of a cluster of nearly equal
eigenvalues are compared as that subspace, never one by one.

- `score_sin`: sine of the largest principal angle between the span of
  the program's first m score columns and the reference's first m PCs;
- `loading_sin`: the same between the loadings and the reference's
  left singular vectors over the kept SNPs;
- `eval_err`: the largest relative error of the first m eigenvalues;
- `kept_mismatch`: SNPs whose QC decision differs from the reference's;
- `moment_err`: the largest relative error of a kept SNP's mean or
  standard deviation;
- `ritz_err`: how far the program's k (eigenvalue, score) pairs, all of
  them and not only the compared m, are from Ritz pairs of the data:
  with V = scores / sigma, the largest of |(V^T C V)_ij - delta_ij
  lambda_i| / sqrt(lambda_i lambda_j) (C = A^T A / (N - 1)), of
  |(V^T V)_ij - delta_ij| and, where the job returns loadings, of
  ||L_j - A v_j / sigma_j|| / ||A v_j / sigma_j||.  It needs no
  converged reference, so it holds the PCs past the last eigengap too.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

GAP = 0.25


def separated_prefix(evals: np.ndarray, k: int) -> int:
    """The number m of leading PCs compared; 0 when no gap <= k falls by
    a factor of 1 + GAP (a matrix without structure)."""
    ev = np.asarray(evals, np.float64)
    for j in range(min(k, len(ev) - 1), 0, -1):
        if ev[j - 1] >= (1 + GAP) * ev[j]:
            return j
    return 0


def subspace_sin(a: np.ndarray, b: np.ndarray) -> float:
    """Sine of the largest principal angle between span(a) and span(b),
    two (n, m) matrices of full column rank."""
    qa = np.linalg.qr(np.asarray(a, np.float64))[0]
    qb = np.linalg.qr(np.asarray(b, np.float64))[0]
    # The part of span(a) outside span(b): its largest singular value is
    # the sine, accurate also for small angles (1 - cos^2 is not).
    resid = qa - qb @ (qb.T @ qa)
    return float(np.linalg.svd(resid, compute_uv=False)[0])


def eval_err(prog: np.ndarray, ref: np.ndarray, m: int) -> float:
    p = np.asarray(prog, np.float64)[:m]
    r = np.asarray(ref, np.float64)[:m]
    return float(np.max(np.abs(p / r - 1.0)))


def pca_numbers(scores: np.ndarray, evals: np.ndarray, ref_v: np.ndarray,
                ref_evals: np.ndarray, m: int, loadings: Optional[np.ndarray] = None,
                ref_u: Optional[np.ndarray] = None) -> dict:
    """`score_sin`, `eval_err` and, with loadings, `loading_sin` of one
    job's output against the reference (ref_v (N, >= m), ref_u (D, m))."""
    out = {"score_sin": subspace_sin(scores[:, :m], ref_v[:, :m]),
           "eval_err": eval_err(evals, ref_evals, m)}
    if loadings is not None and ref_u is not None:
        out["loading_sin"] = subspace_sin(loadings[:, :m], ref_u[:, :m])
    return out


def moment_err(mean: np.ndarray, std: np.ndarray, ref_mean: np.ndarray,
               ref_std: np.ndarray) -> float:
    rm = np.asarray(ref_mean, np.float64)
    rs = np.asarray(ref_std, np.float64)
    e_m = np.abs(np.asarray(mean, np.float64) - rm) / np.maximum(np.abs(rm), 1e-300)
    e_s = np.abs(np.asarray(std, np.float64) - rs) / np.maximum(rs, 1e-300)
    return float(max(e_m.max(initial=0.0), e_s.max(initial=0.0)))


def ritz_numbers(evals: np.ndarray, sums: dict) -> dict:
    """`ritz_err` of one job from its eigenvalues and its `ritz_sums`
    (reference.pca), with its parts beside it: `ritz_pairs` (V^T C V),
    `ritz_orth` (V^T V) and, with loadings, `ritz_load`; a part that is
    not finite reads infinite."""
    lam = np.asarray(evals, np.float64)
    with np.errstate(all="ignore"):
        parts = {"ritz_pairs": np.abs(sums["h"] - np.diag(lam)) / np.sqrt(np.outer(lam, lam)),
                 "ritz_orth": np.abs(sums["vtv"] - np.eye(len(lam)))}
        if "load_err" in sums:
            parts["ritz_load"] = np.sqrt(sums["load_err"] / sums["load_ref"])
    out = {k: float(v.max()) if np.isfinite(v).all() else float("inf")
           for k, v in parts.items()}
    out["ritz_err"] = max(out.values())
    return out


def worst(readings: list) -> dict:
    """The largest reading of each number over several jobs."""
    out: dict = {}
    for r in readings:
        for key, val in r.items():
            out[key] = max(out.get(key, val), val)
    return out

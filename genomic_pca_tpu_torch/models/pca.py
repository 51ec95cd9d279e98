"""Streamed randomized PCA (the `rfit` equivalent) and projection of new
samples, on the port.

Counterpart of `genomic_pca_tpu/models/pca.py`: validate k, widen the
sketch to the 128-lane width the reference kernels pad to, draw the
Gaussian sketch from a seeded generator (utils/rng.py), and run the PCA
through the resident container's `pca_core`, the host-streamed
container's `power_iterate` and `tsq_and_capture`, or the plain power
loop over any operator's `gram_apply` (the test oracle
`ops.stream.StripedMatrix`).  `transform` (float64
on the host), `transform_device` (a dense container over the new
samples, then `left_apply`) and `StripProjector` (one projector reused
across strips) project new samples through fitted loadings.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.errors import ComputeError
from genomic_pca_tpu_torch.ops.rsvd import subspace_residual
from genomic_pca_tpu_torch.ops.standardize import MISSING, standardize_rows
from genomic_pca_tpu_torch.utils.profiling import span, to_host
from genomic_pca_tpu_torch.utils.rng import normal

log = logging.getLogger(__name__)

MXU_LANES = 128


def lane_fill_width(ell: int, n: int, d: int) -> int:
    """Round a sketch width up to 128 columns (capped by the matrix
    dims).  Kept from the reference because it changes the algorithm:
    the default k = 10 + 10 oversamples becomes a 128-wide subspace."""
    cap = min(n, d)
    filled = -(-ell // MXU_LANES) * MXU_LANES
    return max(ell, min(filled, cap))


@dataclasses.dataclass
class PcaResult:
    scores: np.ndarray  # (n_samples, k) = V * sigma
    eigenvalues: np.ndarray  # (k,) sigma^2 / (n_samples - 1)
    singular_values: np.ndarray  # (k,)
    loadings: Optional[np.ndarray]  # (n_variants, k) or None
    k: int
    n_iter_done: Optional[int] = None


def validate_k(k: int, n_samples: int, n_features: int) -> int:
    """k validation with the reference's clamp/warn semantics."""
    if n_samples < 2:
        raise ComputeError(f"PCA requires at least 2 samples, got {n_samples}.")
    if n_features < 1:
        raise ComputeError("PCA requires at least 1 feature.")
    if k < 1:
        raise ComputeError(f"Number of components k must be >= 1, got {k}.")
    upper = min(n_samples, n_features)
    if k > upper:
        log.warning(
            "Requested k=%d exceeds min(n_samples, n_features)=%d; clamping.",
            k,
            upper,
        )
        return upper
    return k


def streamed_pca(
    matrix,
    k: int,
    n_oversamples: int = 10,
    n_power_iter: int = 4,
    seed: Optional[int] = None,
    compute_loadings: bool = False,
    lane_fill: bool = True,
    tolerance: Optional[float] = None,
) -> PcaResult:
    """Randomized PCA of the implicit standardized matrix A (D x N).

    A resident container (parallel.sharded.ShardedMatrix) runs the whole
    PCA in its `pca_core`.  A host-streamed one (ops.streaming
    .StreamingMatrix) runs `power_iterate`, one streaming pass per
    iteration, then the Rayleigh-Ritz Gram; with `compute_loadings` that
    pass also captures A B (`tsq_and_capture`), so the loadings (A B) W /
    sigma need no further pass over the matrix.  Any other operator (the
    test oracle ops.stream.StripedMatrix) runs the plain power loop of
    the JAX package: `gram_apply`, the subspace residual from the second
    pass when `tolerance` is set, a Householder QR, then the same
    Rayleigh-Ritz finalization with loadings from `right_apply`.  With a
    container over several ranks every rank makes this call: each draws
    the same sketch from the seed, and the scores and the gathered
    loadings are the same on every rank.

    The call is the span `gp.pca`; inside it `gp.pca.sketch` (the host
    draw and its upload), the passes' and orthonormalisations' spans of
    the container, and `gp.pca.to_host` (the results' downloads)."""
    with span("gp.pca"):
        if not (hasattr(matrix, "pca_core") or hasattr(matrix, "power_iterate")
                or hasattr(matrix, "gram_apply")):
            raise TypeError(
                "streamed_pca needs an operator with pca_core (resident), "
                "power_iterate (host-streamed) or gram_apply (the plain loop)."
            )
        n = matrix.n_samples
        d = matrix.n_rows
        k = validate_k(k, n, d)
        ell = min(k + n_oversamples, min(n, d))
        if lane_fill:
            ell = lane_fill_width(ell, n, d)

        with span("gp.pca.sketch"):
            b = normal((n, ell), seed if seed is not None else 0, "rfit_sketch",
                       matrix.device)
        n_iter = max(n_power_iter, 1)
        n_done = n_iter
        if hasattr(matrix, "pca_core"):
            out = matrix.pca_core(b, n_iter, k, tolerance=tolerance)
            if tolerance is None:
                v_k, sigma_k, evals_k, loadings = out
            else:
                v_k, sigma_k, evals_k, loadings, n_done = out
        else:
            if hasattr(matrix, "power_iterate"):
                out = matrix.power_iterate(b, n_iter, tolerance=tolerance)
                b, n_done = (out, n_iter) if tolerance is None else out
            else:
                for it in range(n_iter):
                    t = matrix.gram_apply(b)  # A^T A B, one pass
                    res = None
                    if tolerance is not None and it > 0:
                        res = float(to_host(subspace_residual(b, t)))
                    b, _ = torch.linalg.qr(t)
                    if res is not None and res < tolerance:
                        n_done = it + 1
                        break
            fused = compute_loadings and hasattr(matrix, "tsq_and_capture")
            if fused:
                g, ab = matrix.tsq_and_capture(b)  # (l, l), (D, l) host
            else:
                g = matrix.tsq_accumulate(b)
            evals, w = torch.linalg.eigh(g)
            order = torch.argsort(evals, descending=True)
            evals = torch.clamp(evals[order], min=0.0)
            w = w[:, order]
            sigma = torch.sqrt(evals)
            v_k = (b @ w)[:, :k]
            sigma_k, evals_k = sigma[:k], evals[:k]
            loadings = None
            if compute_loadings:
                s_np = to_host(sigma_k).numpy()
                inv_sigma = np.where(s_np > 0, 1.0 / np.where(s_np > 0, s_np, 1.0), 0.0)
                c = (ab @ to_host(w[:, :k]).numpy() if fused
                     else matrix.right_apply(v_k))
                loadings = (c * inv_sigma[None, :]).astype(np.float32)
        if n_done < n_iter:
            log.info("rfit tolerance %.3g reached after %d / %d power iterations.",
                     tolerance, n_done, n_iter)
        with span("gp.pca.to_host"):
            sigma = to_host(sigma_k).numpy()
            scores = to_host(v_k).numpy() * sigma[None, :]
            evals_np = to_host(evals_k).numpy()
        return PcaResult(
            scores=scores,
            eigenvalues=evals_np / max(n - 1, 1),
            singular_values=sigma,
            loadings=loadings if compute_loadings else None,
            k=k,
            n_iter_done=n_done,
        )


def transform(
    new_geno: np.ndarray,
    loadings: np.ndarray,
    mean: np.ndarray,
    std: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Project NEW samples into the fitted PC space, in float64 on the host.

    `new_geno` is (n_snps, n_new) int8 dosages over the fitted SNP set
    (PcaSnpId order); `mean` / `std` are the TRAINING moments (std None:
    center-only, the VCF workflow's convention).  Missing (-127) imputes
    to the training mean; SNPs with std == 0 contribute zero.  Returns
    (n_new, k) f32 scores."""
    g = np.asarray(new_geno, dtype=np.float64)
    valid = np.asarray(new_geno) != MISSING
    mean = np.asarray(mean, dtype=np.float64)
    x = np.where(valid, g, mean[:, None]) - mean[:, None]
    if std is not None:
        s = np.asarray(std, dtype=np.float64)
        x *= np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0)[:, None]
    return (x.T @ np.asarray(loadings, dtype=np.float64)).astype(np.float32)


def transform_device(
    new_geno: np.ndarray,
    loadings: np.ndarray,
    mean: np.ndarray,
    std: Optional[np.ndarray] = None,
    device="cuda",
) -> np.ndarray:
    """`transform` on `device`: the dense int8 container over the new
    samples with the TRAINING moments (`from_arrays`), then `left_apply`
    of the loadings.  Missing genotypes standardize to zero, the
    impute-to-training-mean of the host path."""
    from genomic_pca_tpu_torch.parallel.sharded import ShardedMatrix

    new_geno = np.asarray(new_geno, dtype=np.int8)
    mean = np.asarray(mean, dtype=np.float32)
    stds = (np.ones_like(mean) if std is None
            else np.asarray(std, dtype=np.float32))
    sm = ShardedMatrix.from_arrays(iter([new_geno]), means=[mean], stds=[stds],
                                   device=device)
    return sm.left_apply(np.asarray(loadings, dtype=np.float32)).astype(np.float32)


class StripProjector:
    """One projector reused across strips of up to `strip_rows` SNPs:
    device buffers for the strip, its moments and its loadings are made
    once, and each call fills them and returns the strip's partial scores
    (n_new, k).  Rows past a short strip are inert (inv_std = 0), as are
    SNPs with std == 0; `std=None` is center-only.  Plain torch on
    `device` (the reference's jitted einsum, outside any kernel)."""

    def __init__(self, strip_rows: int, n_new: int, k: int, device="cuda") -> None:
        self.rows = int(strip_rows)
        self.n_new = int(n_new)
        self.k = int(k)
        self.device = torch.device(device)
        dev = self.device
        self._g = torch.zeros((self.rows, self.n_new), dtype=torch.int8, device=dev)
        self._m = torch.zeros(self.rows, dtype=torch.float32, device=dev)
        self._iv = torch.zeros(self.rows, dtype=torch.float32, device=dev)
        self._w = torch.zeros((self.rows, self.k), dtype=torch.float32, device=dev)

    def __call__(
        self,
        g_strip: np.ndarray,
        loadings: np.ndarray,
        mean: np.ndarray,
        std: Optional[np.ndarray] = None,
    ) -> np.ndarray:
        """Partial scores (n_new, k) f32 of one strip of model SNP rows."""
        g_strip = np.asarray(g_strip, dtype=np.int8)
        r = g_strip.shape[0]
        if r > self.rows or g_strip.shape[1] != self.n_new:
            raise ValueError(
                f"strip shape {g_strip.shape} exceeds projector shape "
                f"({self.rows}, {self.n_new})"
            )
        mean = np.asarray(mean, dtype=np.float32)
        if std is None:
            iv = np.ones(r, dtype=np.float32)
        else:
            s = np.asarray(std, dtype=np.float32)
            iv = np.where(s > 0, 1.0 / np.where(s > 0, s, 1.0), 0.0).astype(np.float32)
        self._g[:r].copy_(torch.from_numpy(g_strip))
        self._m[:r].copy_(torch.from_numpy(mean))
        self._iv[:r].copy_(torch.from_numpy(iv))
        self._iv[r:] = 0.0
        self._w[:r].copy_(torch.from_numpy(np.asarray(loadings, dtype=np.float32)))
        self._w[r:] = 0.0
        x = standardize_rows(self._g, self._m, self._iv)
        return to_host(x.T @ self._w).numpy()

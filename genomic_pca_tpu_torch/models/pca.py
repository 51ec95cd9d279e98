"""The port's randomized PCA (the `rfit` equivalent), and projection of
new samples.

Counterpart of `genomic_pca_tpu/models/pca.py`.  The core is written
once, here, over the passes of a production container
(`ops.operator.StandardizedOperator`): `power_iterate`, then
`rayleigh_ritz` (the Gram, `eigh` and the loadings); `pca_core` runs
both.  Each of its passes with its all-reduce is a `gp.pass.<pass>`
span, named as the benchmark's roofline files name the passes; the
orthonormalisations (CholQR2, the Householder QR, `eigh`) are
`gp.pca.orth`, the loadings' gather and download `gp.pca.to_host`.
`streamed_pca` draws the seeded sketch (utils/rng.py), 128 lanes wide
as the reference kernels pad it, and runs the core.  `transform`
(float64 on the host), `transform_device` (a dense container over the
new samples, then `left_apply`) and `StripProjector` (one projector
reused across strips) project new samples through fitted loadings.
"""

from __future__ import annotations

import dataclasses
import logging
from typing import Optional

import numpy as np
import torch

from genomic_pca_tpu_torch.errors import ComputeError
from genomic_pca_tpu_torch.ops.operator import StandardizedOperator, StandardizedProducts
from genomic_pca_tpu_torch.ops.rsvd import centre_samples, cholqr2_q, subspace_residual
from genomic_pca_tpu_torch.ops.standardize import MISSING, standardize_rows
from genomic_pca_tpu_torch.ops.stream import plain_pca
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


# ---- the randomized-PCA core ---------------------------------------------
def _iterate(op: StandardizedOperator, b0, n_iter: int, tolerance: Optional[float]):
    """`power_iterate` with the basis left in the container's layout."""
    n = op.n_samples

    def step(name, b):  # the container's pass `name`, and its span
        with span(f"gp.pass.{name}"):
            t = getattr(op, name)(b)
        return centre_samples(t, n)

    def orth(t):
        with span("gp.pca.orth"):
            return cholqr2_q(t) if op.resident else torch.linalg.qr(t)[0]

    q8 = op.kernel_precision == "q8"
    n_steer = max(n_iter - op.q8_polish, 0) if q8 else n_iter
    b = centre_samples(op.basis(b0), n)
    done, res = 0, float("inf")
    while done < n_steer and (tolerance is None or res >= tolerance):
        t = step("q8_pass" if q8 else "exact_pass", b)
        if tolerance is not None and done > 0:
            # From merged data, identical on every rank: every rank exits
            # at the same step.
            res = float(to_host(subspace_residual(b, t)))
        b = orth(t)
        done += 1
    for _ in range(n_iter - n_steer):
        b = orth(step("exact_pass", b))
    if op.resident:
        with span("gp.pca.orth"):
            b = torch.linalg.qr(b)[0]
    return b, done + n_iter - n_steer


def power_iterate(op: StandardizedOperator, b0, n_iter: int,
                  tolerance: Optional[float] = None):
    """Subspace iteration from the (n_samples, l) sketch `b0`: ((n_samples,
    l) orthonormal basis, passes run).  `tolerance` ends the steering
    passes (int8 under kernel_precision "q8", else exact) on the subspace
    residual, after two at least; under "q8" the `q8_polish` exact passes
    then run in full.  The basis and every pass are held orthogonal to
    the samples' ones vector."""
    q, done = _iterate(op, b0, n_iter, tolerance)
    return q[: op.n_samples], done


def rayleigh_ritz(op: StandardizedOperator, q: torch.Tensor, k: int):
    """The Rayleigh-Ritz finish of the orthonormal basis `q` (container
    layout): (v (n_samples, k), sigma (k,), evals (k,) on the device,
    loadings (n_rows, k) numpy).  `eigh` of (A Q)^T (A Q), descending and
    clipped at 0; V = Q W; loadings A V / sigma, sigma = 0 giving 0."""
    with span("gp.pass.rr_gram"):
        g, right = op.ritz_gram(q)
    with span("gp.pca.orth"):
        evals, w = torch.linalg.eigh(g)
        order = torch.argsort(evals, descending=True)
        evals = torch.clamp(evals[order], min=0.0)
        w = w[:, order]
        sigma = torch.sqrt(evals)
        v_full = q @ w  # right singular vectors, in the layout of q
        v_k = v_full[:, :k].contiguous()
    s_k = sigma[:k]
    # The loadings run even when the caller did not ask for them: the
    # rfit traffic (benchmark/traffic/rfit_centered.json) times this pass
    # and its download.  Skipping them unasked is a change of that cell's
    # work, to be made here, once, for every container.
    with span("gp.pass.loadings"):
        c = right(v_k, w[:, :k])
        inv_sigma = torch.where(s_k > 0, 1.0 / torch.where(s_k > 0, s_k, 1.0),
                                torch.zeros_like(s_k))
        c = c * inv_sigma.to(c.device)[None, :]  # streamed rows: on the host
    with span("gp.pca.to_host"):
        loadings = op.rows_to_host(c)
    return v_full[: op.n_samples, :k], s_k, evals[:k], loadings


def pca_core(op: StandardizedOperator, b0, n_iter: int, k: int,
             tolerance: Optional[float] = None):
    """`power_iterate` then `rayleigh_ritz` from the sketch `b0`: (v,
    sigma, evals, loadings, passes run)."""
    q, done = _iterate(op, b0, n_iter, tolerance)
    return rayleigh_ritz(op, q, k) + (done,)


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

    A production container (`ops.operator.StandardizedOperator`) runs
    `pca_core`, which computes the loadings whether or not they are
    asked for; the test oracle ops.stream.StripedMatrix runs the plain
    power loop of the JAX package (`ops.stream.plain_pca`).  With a
    container over several ranks every rank makes this call: each draws
    the same sketch from the seed, and the scores and the gathered
    loadings are the same on every rank.

    The call is the span `gp.pca`; inside it `gp.pca.sketch` (the host
    draw and its upload), the core's spans, and `gp.pca.to_host` (the
    results' downloads)."""
    with span("gp.pca"):
        if not isinstance(matrix, StandardizedProducts):
            raise TypeError(
                "streamed_pca needs the passes of pca_core (ops.operator"
                ".StandardizedOperator) or the products of the plain loop "
                "(gram_apply, tsq_accumulate, right_apply).")
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
        if isinstance(matrix, StandardizedOperator):
            v_k, sigma_k, evals_k, loadings, n_done = pca_core(
                matrix, b, n_iter, k, tolerance)
        else:
            v_k, sigma_k, evals_k, loadings, n_done = plain_pca(
                matrix, b, n_iter, k, tolerance, compute_loadings)
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

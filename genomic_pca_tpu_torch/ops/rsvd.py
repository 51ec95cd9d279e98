"""Randomized SVD and the orthonormalisation / quantisation glue.

Torch counterparts of `genomic_pca_tpu/ops/rsvd.py`.  Float32 products
here run in full f32: the package turns TF32 off at import
(`__init__.py`), matching the reference's `Precision.HIGHEST`.

Every function takes leading batch dimensions where the reference uses
`jax.vmap` (the EigenSNP stage-1 rSVD runs one per LD block).
"""

from __future__ import annotations

from typing import Tuple

import torch


def cholqr2_q(t: torch.Tensor) -> torch.Tensor:
    """Two-pass Cholesky-QR orthonormal factor of tall (..., N, L) blocks.

    Same discipline as the reference: columns pre-normalised (1e-12
    guard) and a 1e-6 ridge on the (L, L) Gram, so zero columns (padding,
    a rank-deficient sketch, inert bucket rows) stay finite and stay
    zero."""
    ell = t.shape[-1]
    eye = torch.eye(ell, dtype=t.dtype, device=t.device)
    for _ in range(2):
        t = t / (torch.linalg.norm(t, dim=-2, keepdim=True) + 1e-12)
        r = torch.linalg.cholesky(t.mT @ t + 1e-6 * eye)
        # X r^T = t  ->  X = t r^{-T}
        t = torch.linalg.solve_triangular(r.mT, t, upper=True, left=False)
    return t


def _qr_q(a: torch.Tensor) -> torch.Tensor:
    return torch.linalg.qr(a)[0]


def sketch_width(k: int, n_oversamples: int, m: int, n: int) -> int:
    """ell = min(k + n_oversamples, m, n), the reference's sketch width."""
    return min(k + n_oversamples, min(m, n))


def rsvd(
    x: torch.Tensor,
    omega: torch.Tensor,
    k: int,
    n_oversamples: int = 10,
    n_power_iter: int = 2,
    orth: str = "qr",
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Randomized truncated SVD of (..., m, n) matrices: (U (..., m, k),
    s (..., k), Vt (..., k, n)).

    Halko-Martinsson-Tropp with re-orthonormalisation after every
    product, as the reference `rsvd`.  `orth` is "qr" (Householder) or
    "cholqr2".  The sketch `omega` (..., n, sketch_width(...)) stands
    where the reference takes a PRNG key: callers draw it from the port's
    seeded generators, tests hand both packages the same one."""
    if orth not in ("qr", "cholqr2"):
        raise ValueError(f"orth must be 'qr' or 'cholqr2', got {orth!r}")
    m, n = x.shape[-2:]
    ell = sketch_width(k, n_oversamples, m, n)
    if omega.shape[-2:] != (n, ell):
        raise ValueError(f"omega must be (..., {n}, {ell}), got {tuple(omega.shape)}")
    orth_q = _qr_q if orth == "qr" else cholqr2_q
    q = orth_q(x @ omega)
    for _ in range(n_power_iter):
        z = orth_q(x.mT @ q)
        q = orth_q(x @ z)
    ub, s, vt = torch.linalg.svd(q.mT @ x, full_matrices=False)
    u = q @ ub
    return u[..., :k], s[..., :k], vt[..., :k, :]


def exact_svd(x: torch.Tensor, k: int):
    """Exact truncated SVD (small matrices, tests)."""
    u, s, vt = torch.linalg.svd(x, full_matrices=False)
    return u[..., :k], s[..., :k], vt[..., :k, :]


def sign_canonicalize(u: torch.Tensor, vt: torch.Tensor):
    """Fix the sign of singular pairs: the entry of largest |value| in
    each column of U is made positive, applied to Vt alike."""
    idx = torch.argmax(u.abs(), dim=0)
    signs = torch.sign(u[idx, torch.arange(u.shape[1], device=u.device)])
    signs = torch.where(signs == 0, torch.ones_like(signs), signs)
    return u * signs[None, :], vt * signs[:, None]


def quantize_basis(bp: torch.Tensor):
    """Padded f32 basis -> (int8 basis, (1, 1) scale, (1, L) scaled
    column sums) with ONE global scale, as the reference quantises it."""
    sb = torch.clamp(bp.abs().max(), min=1e-30) / 127.0
    bq = torch.clamp(torch.round(bp / sb), -127.0, 127.0).to(torch.int8)
    csum = (bq.sum(dim=0, dtype=torch.float32) * sb)[None, :]
    return bq, sb.reshape(1, 1), csum


def centre_samples(t: torch.Tensor, n: int) -> torch.Tensor:
    """(N_pad, L) sample-space columns with each column's mean over the
    first `n` rows (the real samples) taken out and the rows past them
    zero: the columns projected orthogonal to the ones vector of the
    samples.

    Each row of the standardized matrix A is centred on its own valid
    calls, so A 1 = 0: every right singular vector of a nonzero singular
    value, and every exact A^T A B, is orthogonal to the ones vector.
    The passes do not keep that.  bf16 rounds each row's scale and shift
    apart, so A_bf16 1 = n delta, delta_i up to half a bf16 step of
    mean_i / std_i, and A_bf16^T A_bf16 gains a direction along the ones
    vector of eigenvalue sum(delta_i^2) (in sigma^2 / (n - 1)): it grows
    with the rows, and stands above the bulk of the spectrum, which falls
    towards 1 as the samples outnumber the rows.  A q8 steering pass,
    which reads a missing call as -mean_i / std_i, adds one of its own.
    A power loop whose basis is held orthogonal to the ones vector never
    takes that direction in, so its Rayleigh-Ritz pairs are pairs of the
    data."""
    real = t[:n]
    out = torch.zeros_like(t)
    out[:n] = real - real.mean(dim=0, keepdim=True)
    return out


def subspace_residual(b: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """||T - B (B^T T)||_F / ||T||_F, the rfit tolerance metric."""
    proj = b.T @ t
    return torch.linalg.norm(t - b @ proj) / (torch.linalg.norm(t) + 1e-30)

"""PCA of a standardized matrix A (D x N) given as row blocks.

`blocks()` yields (R, N) standardized row blocks on the device, the same
rows in the same order every time it is called.  Two solvers, and
`solve`, which chooses between them by the sample count as every job's
judge does:

- `gram_pca`: the float64 Gram A^T A accumulated over the blocks, then
  `eigh`: exact, for N up to some ten thousand samples (the control
  rounds the blocks it passes);
- `subspace_pca`: blocked subspace iteration (T = A^T (A Q), QR) and a
  Rayleigh-Ritz step, for any N; float32 products with TF32 off,
  accumulated over blocks in float64.  With `rounding`, every operand
  of every product is rounded to that dtype first (`round_to`, scaled by
  its largest magnitude): the control.

`ritz_sums` reads what the program answered against the data: for each
job's k (score, eigenvalue) pairs, the Gram of A V and the loadings' gap
from A V / sigma, so that every one of the k PCs is held to the matrix,
converged or not.

Over several ranks each rank passes its own rows and `all_reduce` sums
the (N x L) and (L x L) partial results (torch.distributed's SUM).
Eigenvalues are sigma^2 / (N - 1), descending.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional

import numpy as np
import torch

Blocks = Callable[[], Iterable[torch.Tensor]]

# Columns (jobs x k) that one pass of `ritz_sums` carries.
RITZ_COLS = 512

# Above this many samples the reference solves by subspace iteration; at
# or below it by the exact float64 Gram.
GRAM_MAX_SAMPLES = 16_384
# The reference's subspace: k + this many columns, and its passes.  Its
# error in the compared PCs falls as (bulk edge / lambda_m)^passes from
# a Gaussian start: at ukb_pca's size 2 passes leave a sine of 1.3e-3
# against 16, 4 passes 1.1e-7 and 8 passes 8e-8, float32 rounding.
REF_EXTRA_COLS = 24
REF_ITERS = 8
# Genotypes in one block of the reference's products: rfit groups its
# strips to it, the EigenSNP judge reads this many above
# GRAM_MAX_SAMPLES, so that no block of a wide cohort grows with N.
BLOCK_ELEMS = 1 << 29


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _identity(t: torch.Tensor) -> torch.Tensor:
    return t


def round_to(x: torch.Tensor, rounding, per_column: bool = False) -> torch.Tensor:
    """`x` rounded to the dtype `rounding` and back, scaled first so that
    its largest magnitude (of the tensor, or of each column) meets the
    dtype's largest finite value, as low-precision products scale their
    operands; None leaves `x` as it is."""
    if rounding is None:
        return x
    amax = x.abs().amax(dim=0, keepdim=True) if per_column else x.abs().amax()
    scale = torch.finfo(rounding).max / torch.clamp(amax, min=1e-30)
    return (x * scale).to(rounding).to(x.dtype) / scale


def exact(n: int) -> bool:
    """Whether the judge of `n` samples solves by the float64 Gram (its
    blocks float64) rather than by subspace iteration (float32 blocks)."""
    return n <= GRAM_MAX_SAMPLES


def rounded(blocks: Blocks, rounding) -> Blocks:
    """`blocks` with each block rounded to `rounding` (`round_to`); None
    gives `blocks` itself."""
    if rounding is None:
        return blocks
    return lambda: (round_to(x, rounding) for x in blocks())


def solve(blocks: Blocks, n: int, k: int, device, all_reduce=_identity, seed: int = 0,
          rounding=None, n_iter: Optional[int] = None, ell: Optional[int] = None):
    """(V, eigenvalues) of the judge: the float64 Gram of the blocks, each
    rounded to `rounding`, at or below GRAM_MAX_SAMPLES; above it, or
    with `n_iter` given (the control in the program's place),
    `subspace_pca` over `ell` (k + REF_EXTRA_COLS) columns for `n_iter`
    (REF_ITERS) passes from `seed`, every operand rounded to
    `rounding`."""
    if exact(n) and n_iter is None:
        return gram_pca(rounded(blocks, rounding), n, device, all_reduce)
    return subspace_pca(blocks, n, ell or min(k + REF_EXTRA_COLS, n), n_iter or REF_ITERS,
                        seed, device, all_reduce, rounding=rounding)


def gram_pca(blocks: Blocks, n: int, device, all_reduce=_identity):
    """(V (N, N) eigenvectors as columns, eigenvalues (N,)), descending."""
    _no_tf32()
    g = torch.zeros((n, n), dtype=torch.float64, device=device)
    for x in blocks():
        x = x.to(torch.float64)
        g += x.T @ x
    g = all_reduce(g)
    evals, evecs = torch.linalg.eigh(g)
    return evecs.flip(1), evals.flip(0).clamp(min=0) / max(n - 1, 1)


def subspace_pca(blocks: Blocks, n: int, ell: int, n_iter: int, seed: int,
                 device, all_reduce=_identity, rounding=None,
                 q0: Optional[torch.Tensor] = None):
    """(V (N, ell), eigenvalues (ell,)) after `n_iter` passes of T = A^T
    A Q from a Gaussian start (or `q0`), descending."""
    _no_tf32()
    if q0 is None:
        gen = torch.Generator(device="cpu")
        gen.manual_seed(int(seed) & (2**63 - 1))
        q0 = torch.randn((n, ell), generator=gen, dtype=torch.float64)
    q = torch.linalg.qr(q0.to(device=device, dtype=torch.float64))[0]

    def t_of(q):
        qf = round_to(q.to(torch.float32), rounding, per_column=True)
        t = torch.zeros((n, q.shape[1]), dtype=torch.float64, device=device)
        for x in blocks():
            x = round_to(x.to(torch.float32), rounding)
            y = round_to(x @ qf, rounding, per_column=True)
            t += (x.T @ y).to(torch.float64)
        return all_reduce(t)

    for _ in range(n_iter):
        q = torch.linalg.qr(t_of(q))[0]
    qf = round_to(q.to(torch.float32), rounding, per_column=True)
    g = torch.zeros((q.shape[1], q.shape[1]), dtype=torch.float64, device=device)
    for x in blocks():
        y = (round_to(x.to(torch.float32), rounding) @ qf).to(torch.float64)
        g += y.T @ y
    evals, w = torch.linalg.eigh(all_reduce(g))
    order = torch.argsort(evals, descending=True)
    return q @ w[:, order], evals[order].clamp(min=0) / max(n - 1, 1)


def row_loadings(blocks: Blocks, v: torch.Tensor) -> np.ndarray:
    """A V / ||A V|| column by column: (D, m) float64 on the host, the
    left singular vectors of the right ones `v` (N, m)."""
    _no_tf32()
    v = v.to(torch.float64)
    parts = [(x.to(torch.float64) @ v).cpu().numpy() for x in blocks()]
    u = np.concatenate(parts)
    return u / np.maximum(np.linalg.norm(u, axis=0), 1e-300)


def ritz_sums(blocks: Blocks, jobs: list, n: int, device, all_reduce=_identity,
              loadings: Optional[list] = None) -> list:
    """For each job's (scores (N, k), eigenvalues (k,)): with sigma^2 =
    eigenvalue (n - 1) and V = scores / sigma, `h` = V^T A^T A V / (n - 1)
    and `vtv` = V^T V (k x k); with `loadings` (a (D, k) array L for each
    job, or None) also, column by column, `load_err` the sum over rows of
    (L - A V / sigma)^2 and `load_ref` that of (A V / sigma)^2.  All in
    float64, the blocks too; a pass over the blocks carries RITZ_COLS
    columns."""
    _no_tf32()
    out = []
    k = max((np.shape(s)[1] for s, _ in jobs), default=1)
    per = max(1, RITZ_COLS // max(k, 1))
    f64 = torch.float64
    for c0 in range(0, len(jobs), per):
        chunk = jobs[c0:c0 + per]
        sig, vs = [], []
        for scores, evals in chunk:
            lam = torch.as_tensor(np.asarray(evals, np.float64), device=device)
            sig.append(torch.sqrt(lam.clamp(min=0) * max(n - 1, 1)))
            vs.append(torch.as_tensor(np.asarray(scores), device=device).to(f64)
                      / sig[-1][None, :])
        v = torch.cat(vs, 1)  # (N, J k)
        h = [torch.zeros((k, k), dtype=f64, device=device) for _ in chunk]
        lerr = [torch.zeros(k, dtype=f64, device=device) for _ in chunk]
        lref = [torch.zeros(k, dtype=f64, device=device) for _ in chunk]
        lo = 0
        for x in blocks():
            y = x.to(f64) @ v
            for j in range(len(chunk)):
                yj = y[:, j * k:(j + 1) * k]
                h[j] += yj.T @ yj
                lj = None if loadings is None else loadings[c0 + j]
                if lj is not None:
                    want = yj / sig[j][None, :]
                    got = torch.as_tensor(np.asarray(lj[lo:lo + x.shape[0]]),
                                          device=device).to(f64)
                    lerr[j] += ((got - want) ** 2).sum(0)
                    lref[j] += (want ** 2).sum(0)
            lo += x.shape[0]
        for j in range(len(chunk)):
            vj = vs[j]
            got = {"h": (all_reduce(h[j]) / max(n - 1, 1)).cpu().numpy(),
                   "vtv": (vj.T @ vj).cpu().numpy()}
            if loadings is not None and loadings[c0 + j] is not None:
                got["load_err"] = all_reduce(lerr[j]).cpu().numpy()
                got["load_ref"] = all_reduce(lref[j]).cpu().numpy()
            out.append(got)
    return out

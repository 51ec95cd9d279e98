"""The test-oracle operator container of the port.

Counterpart of `genomic_pca_tpu/ops/stream.py`: `StripedMatrix` is the
SIMPLEST implementation of the `ops.operator.StandardizedProducts`
contract, a Python list of device strips multiplied by plain f32
`torch.matmul`: no hand-written kernel, no prefetch, no process group.
It is the independent, obviously-correct implementation the production
containers (`parallel.sharded.ShardedMatrix`, `ops.streaming
.StreamingMatrix`) are held against in tests and in chip_smoke; no
workflow constructs it.

A = diag(inv_std) (G - mean), D x N, never materialized: each product
standardizes one int8 strip (`standardize_rows`, missing -> 0) and
multiplies it, and the strips' partial results are summed in order.

  gram_apply(B)      ->  A^T (A B)        (N, l)  one power-iteration pass
  right_apply(B)     ->  A B on the host  (D, l)  padding removed
  tsq_accumulate(B)  ->  (A B)^T (A B)    (l, l)  condensed Gram

`plain_pca` is the JAX package's power loop over those products alone
(a Householder QR each pass, no q8 steering, no centring), which
`models.pca.streamed_pca` runs on a StripedMatrix: the tests hold the
production core (`models.pca.pca_core`) against it.

The JAX oracle pins `Precision.HIGHEST` on its products; here that is
TF32 being off (`genomic_pca_tpu_torch/__init__.py`), which every pass on
a card asserts rather than inherit a changed setting.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, List, Optional, Sequence

import numpy as np
import torch

from genomic_pca_tpu_torch.ops.rsvd import subspace_residual
from genomic_pca_tpu_torch.ops.standardize import MISSING, standardize_rows
from genomic_pca_tpu_torch.parallel.sharded import host_moments, inv_std_of
from genomic_pca_tpu_torch.utils.profiling import to_host

__all__ = ["MISSING", "Strip", "StripedMatrix", "plain_pca"]


def _check_full_f32(device: torch.device) -> None:
    """The products must accumulate in full f32, as the JAX oracle's
    HIGHEST precision: on a card, TF32 must be off."""
    if device.type == "cuda" and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(
            "StripedMatrix needs full f32 products on the card, but "
            "torch.backends.cuda.matmul.allow_tf32 is True (the port sets "
            "it False on import)."
        )


@dataclasses.dataclass
class Strip:
    """One padded SNP strip: device int8 block + standardization vectors.

    `n_rows` is the number of real (unpadded) SNP rows; padded rows have
    inv_std == 0 so they standardize to zero and contribute nothing.
    """

    geno: torch.Tensor  # int8 (strip_size, n_samples)
    mean: torch.Tensor  # f32 (strip_size,)
    inv_std: torch.Tensor  # f32 (strip_size,)
    n_rows: int


class StripedMatrix:
    """The implicit standardized matrix A (D x N) as a list of strips."""

    def __init__(self, strips: List[Strip], n_samples: int, device):
        self.strips = strips
        self.n_samples = n_samples
        self.n_rows = sum(s.n_rows for s in strips)
        self.device = torch.device(device)

    @staticmethod
    def from_arrays(
        geno_strips: Iterator[np.ndarray],
        means: Optional[Sequence[np.ndarray]] = None,
        stds: Optional[Sequence[np.ndarray]] = None,
        strip_size: int = 2048,
        center_only: bool = False,
        device="cuda",
    ) -> "StripedMatrix":
        """Build from host int8 arrays, repacking/padding to `strip_size`.

        If `means`/`stds` are None they are computed from the data
        (`host_moments`: exact integer counts, float64, cast to f32).
        `center_only=True` sets all inv_std to 1 (the VCF workflow's
        centre-without-scale semantics)."""
        pend_g: List[np.ndarray] = []
        pend_m: List[np.ndarray] = []
        pend_s: List[np.ndarray] = []
        strips: List[Strip] = []
        n_samples = None

        def flush(final: bool) -> None:
            nonlocal pend_g, pend_m, pend_s
            if not pend_g:
                return
            g = np.concatenate(pend_g, axis=0)
            m = np.concatenate(pend_m, axis=0)
            s = np.concatenate(pend_s, axis=0)
            pos = 0
            while g.shape[0] - pos >= strip_size or (final and pos < g.shape[0]):
                end = min(pos + strip_size, g.shape[0])
                strips.append(
                    _make_strip(
                        g[pos:end], m[pos:end], s[pos:end], strip_size, device
                    )
                )
                pos = end
            pend_g = [g[pos:]] if pos < g.shape[0] else []
            pend_m = [m[pos:]] if pos < g.shape[0] else []
            pend_s = [s[pos:]] if pos < g.shape[0] else []

        for i, g in enumerate(geno_strips):
            g = np.asarray(g, dtype=np.int8)
            if n_samples is None:
                n_samples = g.shape[1]
            if means is not None and stds is not None:
                m = np.asarray(means[i], dtype=np.float32)
                s = np.asarray(stds[i], dtype=np.float32)
            else:
                m, s = host_moments(g)
            if center_only:
                s = np.ones_like(m)
            pend_g.append(g)
            pend_m.append(m)
            pend_s.append(s)
            flush(final=False)
        flush(final=True)
        if n_samples is None:
            raise ValueError("No strips provided.")
        return StripedMatrix(strips, n_samples, device)

    # ---- linear-algebra passes -------------------------------------

    def _b(self, b) -> torch.Tensor:
        _check_full_f32(self.device)
        return torch.as_tensor(b, dtype=torch.float32).to(self.device)

    @staticmethod
    def _a(s: Strip) -> torch.Tensor:
        return standardize_rows(s.geno, s.mean, s.inv_std)

    def gram_apply(self, b) -> torch.Tensor:
        """A^T (A B): one full pass. B is (N, l)."""
        b = self._b(b)
        acc = torch.zeros((self.n_samples, b.shape[1]), dtype=torch.float32,
                          device=self.device)
        for s in self.strips:
            a = self._a(s)
            acc = acc + a.T @ (a @ b)
        return acc

    def right_apply_strips(self, b) -> List[torch.Tensor]:
        """A B computed per strip; padded rows included (zero)."""
        b = self._b(b)
        return [self._a(s) @ b for s in self.strips]

    def right_apply(self, b) -> np.ndarray:
        """A B materialized on host with padding removed: (D, l)."""
        outs = [c[: s.n_rows].cpu().numpy()
                for s, c in zip(self.strips, self.right_apply_strips(b))]
        return np.concatenate(outs, axis=0)

    def tsq_accumulate(self, b) -> torch.Tensor:
        """(A B)^T (A B) = B^T A^T A B accumulated strip-wise: (l, l)."""
        b = self._b(b)
        acc = torch.zeros((b.shape[1], b.shape[1]), dtype=torch.float32,
                          device=self.device)
        for s in self.strips:
            c = self._a(s) @ b
            acc = acc + c.T @ c
        return acc


def _make_strip(
    g: np.ndarray, mean: np.ndarray, std: np.ndarray, strip_size: int, device
) -> Strip:
    n_rows, n_samples = g.shape
    if n_rows < strip_size:
        pad = strip_size - n_rows
        g = np.concatenate([g, np.zeros((pad, n_samples), dtype=np.int8)], axis=0)
        mean = np.concatenate([mean, np.zeros(pad, dtype=np.float32)])
        std = np.concatenate([std, np.zeros(pad, dtype=np.float32)])
    inv_std = inv_std_of(std).astype(np.float32)
    dev = torch.device(device)
    return Strip(
        geno=torch.from_numpy(np.ascontiguousarray(g)).to(dev),
        mean=torch.from_numpy(mean.astype(np.float32)).to(dev),
        inv_std=torch.from_numpy(inv_std).to(dev),
        n_rows=n_rows,
    )


def plain_pca(matrix, b, n_iter: int, k: int, tolerance: Optional[float],
              compute_loadings: bool):
    """The oracle's randomized PCA from the sketch `b` over `gram_apply`,
    `tsq_accumulate` and `right_apply`: (v (n_samples, k), sigma (k,),
    evals (k,), loadings (n_rows, k) numpy or None, passes run)."""
    n_done = n_iter
    for it in range(n_iter):
        t = matrix.gram_apply(b)  # A^T A B, one pass
        res = None
        if tolerance is not None and it > 0:
            res = float(to_host(subspace_residual(b, t)))
        b, _ = torch.linalg.qr(t)
        if res is not None and res < tolerance:
            n_done = it + 1
            break
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
        loadings = (matrix.right_apply(v_k) * inv_sigma[None, :]).astype(np.float32)
    return v_k, sigma_k, evals_k, loadings, n_done

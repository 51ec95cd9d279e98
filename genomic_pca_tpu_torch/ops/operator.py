"""The standardized-genotype operator contract of the port.

Counterpart of `genomic_pca_tpu/ops/operator.py`: A = diag(1/std)
(G - mean) applied implicitly.  The randomized PCA is written once, in
`models.pca`; a container gives it passes over its matrix and holds none
of the algorithm.  Three containers implement the contract, each with
its own role:

* `parallel.sharded.ShardedMatrix` - PRODUCTION, device-resident.  The
  genotypes (PLINK 2-bit packed or dense int8) live on the card, rows
  split over the ranks of a process group; every pass runs through the
  hand-written kernels (ops/kernels.py) with one all-reduce.
* `ops.streaming.StreamingMatrix` - PRODUCTION, bigger than the card.
  Strips stay on the host and stream through the prefetch pipeline each
  pass.
* `ops.stream.StripedMatrix` - TEST ORACLE.  The simplest possible
  implementation (a Python list of device strips, plain f32 torch
  products, no kernel, no prefetch, no process group).  It exists so the
  two production containers can be held against an independent,
  obviously-correct implementation; no workflow constructs it.  It has
  the products alone, and runs the oracle's own loop
  (`ops.stream.plain_pca`).
"""

from __future__ import annotations

from typing import Callable, Protocol, Tuple, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class StandardizedProducts(Protocol):
    """Implicit standardized matrix A (n_rows x n_samples): the three
    products of every container."""

    n_rows: int
    n_samples: int

    def gram_apply(self, b: torch.Tensor) -> torch.Tensor:
        """A^T (A B): (n_samples, l) - one power-iteration pass."""
        ...

    def tsq_accumulate(self, b: torch.Tensor) -> torch.Tensor:
        """(A B)^T (A B): (l, l) condensed Gram."""
        ...

    def right_apply(self, b: torch.Tensor) -> np.ndarray:
        """A B on host with padding removed: (n_rows, l)."""
        ...


@runtime_checkable
class StandardizedOperator(StandardizedProducts, Protocol):
    """A production container: the products, plus the passes the core
    in `models.pca` runs.  Passes take a basis in the container's layout
    (`basis`: the resident one pads the samples to `n_pad` with zero
    rows) and merge over the ranks before they return, so what the core
    computes from them is the same on every rank.  `ritz_gram(q)` gives
    (A Q)^T (A Q) and `right(v, w)`, the rows A V of V = Q W, which
    `rows_to_host` brings to (n_rows, k) in PCA row order on every rank.

    `kernel_precision` "q8" makes the core steer with `q8_pass` and end
    with `q8_polish` exact passes.  `resident` (the matrix lives on the
    card) selects the core's orthonormalisation (CholQR2 each pass and
    one closing Householder QR, else a Householder QR each pass) and
    EigenSNP's device block fetch (`fetch_blocks_device`)."""

    device: torch.device
    kernel_precision: str
    q8_polish: int
    resident: bool

    def basis(self, b) -> torch.Tensor: ...

    def exact_pass(self, b: torch.Tensor) -> torch.Tensor: ...

    def q8_pass(self, b: torch.Tensor) -> torch.Tensor: ...

    def ritz_gram(self, q: torch.Tensor) -> Tuple[torch.Tensor, Callable]: ...

    def rows_to_host(self, rows) -> np.ndarray: ...

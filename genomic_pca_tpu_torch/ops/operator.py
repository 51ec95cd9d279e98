"""The standardized-genotype operator contract of the port.

Counterpart of `genomic_pca_tpu/ops/operator.py`: A = diag(1/std)
(G - mean) applied implicitly.  Three containers implement it, each with
its own role:

* `parallel.sharded.ShardedMatrix` - PRODUCTION, device-resident.  The
  genotypes (PLINK 2-bit packed or dense int8) live on the card, rows
  split over the ranks of a process group; every pass runs through the
  hand-written kernels (ops/kernels.py) with one all-reduce.
  `models.pca.streamed_pca` drives it through its `pca_core`.
* `ops.streaming.StreamingMatrix` - PRODUCTION, bigger than the card.
  Strips stay on the host and stream through the prefetch pipeline each
  pass; driven through `power_iterate` and `tsq_and_capture`.
* `ops.stream.StripedMatrix` - TEST ORACLE.  The simplest possible
  implementation (a Python list of device strips, plain f32 torch
  products, no kernel, no prefetch, no process group).  It exists so the
  two production containers can be held against an independent,
  obviously-correct implementation; no workflow constructs it, and
  `streamed_pca` drives it through the plain power loop over
  `gram_apply`.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class StandardizedOperator(Protocol):
    """Implicit standardized matrix A (n_rows x n_samples).

    Required: the three products below.  Optional fast paths that
    models feature-detect with `hasattr`: `power_iterate(b0, n_iter)`,
    `pca_core(b0, n_iter, k)` and `tsq_and_capture(b)`.
    """

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

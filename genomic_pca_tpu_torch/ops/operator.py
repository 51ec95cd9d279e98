"""The standardized-genotype operator contract of the port.

Counterpart of `genomic_pca_tpu/ops/operator.py`: A = diag(1/std)
(G - mean) applied implicitly.  Two implementations: the resident
`parallel.sharded.ShardedMatrix`, which `models.pca.streamed_pca` drives
through its `pca_core` fast path, and the host-streamed
`ops.streaming.StreamingMatrix`, driven through `power_iterate` and
`tsq_and_capture`.
"""

from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch


@runtime_checkable
class StandardizedOperator(Protocol):
    """Implicit standardized matrix A (n_rows x n_samples).

    Optional fast paths that models feature-detect with `hasattr`:
    `power_iterate(b0, n_iter)` and `pca_core(b0, n_iter, k)`.
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

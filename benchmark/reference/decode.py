"""PLINK 1 bytes to dosages, counts and standardized rows, in plain torch.

Codes (counting A1): 00 -> dosage 2, 10 -> 1, 11 -> 0, 01 -> missing.
"""

from __future__ import annotations

from typing import Optional

import torch


def codes(packed: torch.Tensor, n_samples: int) -> torch.Tensor:
    """(R, >= ceil(N / 4)) uint8 -> (R, N) uint8 2-bit codes."""
    r = packed.shape[0]
    c = torch.stack([(packed >> (2 * p)) & 3 for p in range(4)], dim=-1)
    return c.reshape(r, -1)[:, :n_samples]


def counts(code: torch.Tensor) -> torch.Tensor:
    """(R, 4) int64 of (R, N) codes: (dosage-0 calls, dosage-1 calls,
    dosage-2 calls, valid calls)."""
    n0 = (code == 3).sum(1)
    n1 = (code == 2).sum(1)
    n2 = (code == 0).sum(1)
    return torch.stack([n0, n1, n2, n0 + n1 + n2], dim=1)


def moments(cnt: torch.Tensor):
    """float64 (mean, sample std) of each row over its valid calls."""
    c = cnt.to(torch.float64)
    n1, n2, nv = c[:, 1], c[:, 2], c[:, 3]
    mean = (n1 + 2 * n2) / nv.clamp(min=1)
    ss = ((0 - mean) ** 2 * c[:, 0] + (1 - mean) ** 2 * n1 + (2 - mean) ** 2 * n2)
    std = torch.sqrt(torch.where(nv >= 2, ss / (nv - 1).clamp(min=1), 0.0))
    return mean, std


def standardized(packed: torch.Tensor, n_samples: int, mean: torch.Tensor,
                 std: Optional[torch.Tensor], dtype=torch.float64) -> torch.Tensor:
    """(R, N) rows (dosage - mean) / std of packed rows (R, >= ceil(N /
    4)), missing calls 0; `std` None centres only; a zero std standardizes
    the row to 0."""
    code = codes(packed, n_samples)
    x = ((4 - code) >> 1).to(dtype)  # 00 -> 2, 10 -> 1, 11 -> 0
    x.sub_(mean.to(dtype)[:, None])
    if std is not None:
        s = std.to(dtype)
        x.mul_(torch.where(s > 0, 1.0 / torch.where(s > 0, s, 1.0), 0.0)[:, None])
    return x.masked_fill_(code == 1, 0.0)

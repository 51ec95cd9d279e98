"""Standardization of int8 dosage strips (torch).

Counterpart of `genomic_pca_tpu/ops/standardize.py`: x -> g * inv_std +
(-mean * inv_std), the reference's factorization, with missing genotypes
(-127) imputed to the mean (0 after standardization) and rows of
inv_std = 0 (padding, zero-std SNPs) standardizing to all-zeros.  The one
home of the dense missing sentinel and of the f32 dense standardizer.
"""

from __future__ import annotations

import torch

MISSING = -127


def standardize_rows(g_i8: torch.Tensor, mean: torch.Tensor,
                     inv_std: torch.Tensor) -> torch.Tensor:
    """(R, C) int8 with float32 (R,) moments -> (R, C) f32 standardized,
    missing imputed to 0."""
    x = g_i8.to(torch.float32) * inv_std[:, None] + (-mean * inv_std)[:, None]
    return torch.where(g_i8 != MISSING, x, torch.zeros((), device=x.device))


# The reference's jitted strip form computes the same function.
standardize_strip = standardize_rows


def inv_std_from_std(std) -> torch.Tensor:
    std = torch.as_tensor(std, dtype=torch.float32)
    return torch.where(std > 0, 1.0 / torch.where(std > 0, std, 1.0),
                       torch.zeros((), dtype=torch.float32, device=std.device))

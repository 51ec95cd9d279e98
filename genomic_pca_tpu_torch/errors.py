"""Exception hierarchy.

Equivalent of the reference's `DataPrepError` enum + `WrapErr` context
system (reference src/prepare.rs:28-138): typed errors so callers
can distinguish ingest, QC, and compute failures, each carrying a
human-readable context chain (Python exception chaining plays the role
of `wrap_err_with_context`).

A copy of `genomic_pca_tpu/errors.py`: the port keeps its own copy so that it
imports nothing of the JAX package; tests/test_torch_copies.py pins
it to the original.
"""

from __future__ import annotations


class GenomicPcaError(Exception):
    """Base class for all framework errors."""


class BedFormatError(GenomicPcaError, ValueError):
    """Malformed or truncated PLINK .bed/.bim/.fam input."""


class VcfParseError(GenomicPcaError, ValueError):
    """Malformed VCF input or sample-set mismatch."""


class DataPrepError(GenomicPcaError, ValueError):
    """QC / LD-mapping / accessor failures (prepare pipeline)."""


class ComputeError(GenomicPcaError, ValueError):
    """PCA engine failures (invalid shapes, no surviving variants)."""


class PreflightError(GenomicPcaError, RuntimeError):
    """Resource preflight rejected the planned run (e.g. the estimated
    device-upload total exceeds the host budget on a relay backend) —
    a fast actionable error instead of an OOM-killed host."""

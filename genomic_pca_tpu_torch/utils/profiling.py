"""The `--profile-dir` trace: torch.profiler around a whole workflow.

Counterpart of `genomic_pca_tpu/utils/profiling.py`, whose `maybe_trace`
wraps a workflow in `jax.profiler.trace`.  Here `maybe_trace(profile_dir,
device)` wraps it in `torch.profiler.profile`:

- CPU activity always, CUDA activity when `device` is a card;
- no shapes, no stacks and no memory events, so that a CLI run of tens of
  seconds writes megabytes, not gigabytes;
- on exit one Chrome trace in `profile_dir` per rank,
  `trace.rank{r}.json` (open it in Perfetto or chrome://tracing);
- with no directory, no profiler at all.

The hand-written kernels launch through ctypes (ops/kernels.py), outside
PyTorch's dispatcher, so the CPU activity has no operator around them;
CUPTI records them all the same, and the CUDA activity lists them under
their `__global__` names (`q8_right2d_mma_kernel`,
`right_narrow_mma_kernel`, ...).  Only the calling process is traced:
the VCF parse's spawn pool (workflows.py) runs in processes of its own.
"""

from __future__ import annotations

import contextlib
import logging
import os
from typing import Iterator, Optional

import torch

log = logging.getLogger(__name__)


@contextlib.contextmanager
def maybe_trace(profile_dir: Optional[str], device) -> Iterator[None]:
    """torch.profiler around the block when `profile_dir` is given, else
    nothing; the trace is written when the block ends without an error.
    `device` is required: a card's work is traced only when it is named,
    so a caller that left it out would silently lose the CUDA activity."""
    if not profile_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    from genomic_pca_tpu_torch.parallel import mesh

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(profile_dir, exist_ok=True)
    log.info("Capturing a torch.profiler trace (%s) to %s.",
             " + ".join(a.name for a in activities), profile_dir)
    with profile(activities=activities, record_shapes=False, with_stack=False,
                 profile_memory=False) as prof:
        yield
    path = os.path.join(profile_dir, f"trace.rank{mesh.process_index()}.json")
    prof.export_chrome_trace(path)
    log.info("Profiler trace written to %s (Chrome trace format).", path)

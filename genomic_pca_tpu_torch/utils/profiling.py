"""The port's tracing: the `--profile-dir` trace, the program's spans and
its device-to-host byte counter.

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

Spans (`span(name)`): the program's layers, named `gp.<layer>...`, as
`torch.profiler.record_function` ranges whenever a profiler runs (the
`--profile-dir` trace, or any caller's), so a trace says which part of the
program the host was in while the card worked or stood idle.  With no
profiler running a span is two `perf_counter` stamps and one flag check;
it never synchronizes the device.  Its stamps (`seconds`) are what the
program reports as a stage's time (`EigenSnpResult.stage_seconds`,
`PreparedData.stage_seconds`, the workflows' stage table), so a stage
number and its span cover one interval.

`COUNTS["d2h_bytes"]` counts the bytes of every device-to-host copy of
the PCA paths (models/pca.py, models/eigensnp.py, parallel/sharded.py),
made through `to_host`; `COUNTS["table_rows_native"]` and
`COUNTS["table_rows_loop"]` count the .bim and .fam rows that the native
pass and the Python line loop parsed (io/bed.py).  `COUNTS["passes_2d"]`
counts the matrix passes the resident container runs in its 2-D mode
(parallel/sharded.py); it is there only once such a pass has run, so a
run in the 1-D mode has the three counts alone.
`COUNTS["block_fetch_kernel"]` counts the EigenSNP stage 1-2 block
batches that the card's kernel built (`kernels.standardize_runs`, called
by `fetch_blocks_device`), there only once one has.  `reset_counts()`
zeroes the three and takes the others out, as
`kernels.reset_launch_counts()` zeroes the launch counts.
"""

from __future__ import annotations

import contextlib
import logging
import os
import time
from typing import Iterator, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

log = logging.getLogger(__name__)

# The counts every run has; a count of one mode, as "passes_2d", is added
# by the first pass that runs in it (`count`).
_ALWAYS = ("d2h_bytes", "table_rows_native", "table_rows_loop")
COUNTS = dict.fromkeys(_ALWAYS, 0)


def reset_counts() -> None:
    COUNTS.clear()
    COUNTS.update(dict.fromkeys(_ALWAYS, 0))


def count(key: str) -> None:
    COUNTS[key] = COUNTS.get(key, 0) + 1


def to_host(t: torch.Tensor) -> torch.Tensor:
    """`t` as a CPU tensor; a card's tensor adds its bytes to
    COUNTS["d2h_bytes"] (a CPU tensor is returned as it is, uncounted)."""
    if t.is_cuda:
        COUNTS["d2h_bytes"] += t.numel() * t.element_size()
    return t.cpu()


class span:
    """A named range of the program: a `record_function` range while a
    profiler runs, and always the `perf_counter` stamps `t0` / `t1` taken
    inside it (`seconds` once it has ended)."""

    __slots__ = ("name", "t0", "t1", "_range")

    def __init__(self, name: str) -> None:
        self.name = name
        self._range = None

    def __enter__(self) -> "span":
        # A module attribute read at call time: the profiler sets it on
        # start and clears it on stop.
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(self.name)
            self._range.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> None:
        self.t1 = time.perf_counter()
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


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

"""Per-stage wall-clock timing.

The stage summary the JAX package's `utils/timing.py` logs at the end of
a workflow; each stage is a span (utils/profiling.py) named
`gp.workflow.<stage>`, so the stages also appear in `--profile-dir`
traces, and its time is the span's.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Dict, Iterator, List, Tuple

from genomic_pca_tpu_torch.utils.profiling import span

log = logging.getLogger(__name__)


class StageTimer:
    """Collects named stage durations and logs a summary table."""

    def __init__(self) -> None:
        self._stages: List[Tuple[str, float]] = []
        self._t0 = time.perf_counter()

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        s = span(f"gp.workflow.{name}")
        try:
            with s:
                yield
        finally:
            self._stages.append((name, s.seconds))
            log.info("stage '%s' completed in %.3fs", name, s.seconds)

    @property
    def stages(self) -> Dict[str, float]:
        return dict(self._stages)

    def total(self) -> float:
        return time.perf_counter() - self._t0

    def log_summary(self, title: str = "Stage timings") -> None:
        log.info("%s:", title)
        for name, dur in self._stages:
            log.info("  %-40s %10.3fs", name, dur)
        log.info("  %-40s %10.3fs", "TOTAL", self.total())

"""Prover timing: cumulative wall clock per labelled region.

Port of ``KernelTimer`` / ``PROVER_TIMER`` of
``simpleworks_tpu/utils/observability.py``.  The card runs asynchronously,
so a region's wall clock measures what the host enqueued unless the timer
synchronises the card at the region's edges: set ``synchronize`` for
honest per-region device seconds (it adds two device waits a region).
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@dataclass
class KernelTimer:
    """Cumulative wall clock per labelled region."""

    totals: dict[str, float] = field(default_factory=dict)
    #: synchronise the CUDA card at each region's start and end
    synchronize: bool = False

    def _sync(self) -> None:
        if self.synchronize and torch.cuda.is_available():
            torch.cuda.synchronize()

    _lock: threading.Lock = field(default_factory=threading.Lock, repr=False, compare=False)

    @contextmanager
    def region(self, label: str):
        self._sync()
        start = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            dt = time.perf_counter() - start
            with self._lock:  # the proof pipeline's threads share one timer
                self.totals[label] = self.totals.get(label, 0.0) + dt

    def reset(self) -> None:
        self.totals.clear()


#: process-wide prover timer: every ``marlin.prove`` and ``marlin.index``
#: adds its regions here
PROVER_TIMER = KernelTimer()

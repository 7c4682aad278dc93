"""Observability: constraint accounting, prover timing and device traces.

Port of ``simpleworks_tpu/utils/observability.py``.  Constraints are
attributed to the namespaces the constraint system records (the reference's
``ConstraintLayer``); :class:`KernelTimer` keeps the cumulative wall clock
per labelled region.  The card runs asynchronously, so a region's wall clock
measures what the host enqueued unless the timer synchronises the card at
the region's edges: set ``synchronize`` for honest per-region device seconds
(it adds two device waits a region).  :func:`device_trace` records a
``torch.profiler`` trace of a region (the card's kernels beside the host's
ops) where the reference records a JAX profiler trace.
"""

from __future__ import annotations

import os
import sys
import threading
import time
from collections import Counter
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


def constraint_counts_by_namespace(cs) -> dict[str, int]:
    """Constraints attributed to each namespace path (empty path: ``<root>``)."""
    return dict(Counter(name or "<root>" for name in cs.constraint_names))


def summarize_circuit(cs) -> str:
    lines = [
        f"constraints: {cs.num_constraints}",
        f"instance variables: {cs.num_instance_variables}",
        f"witness variables: {cs.num_witness_variables}",
        f"non-zero entries (max over A/B/C): {cs.num_nonzero()}",
    ]
    for ns_path, count in sorted(
        constraint_counts_by_namespace(cs).items(), key=lambda kv: -kv[1]
    )[:20]:
        lines.append(f"  {ns_path}: {count}")
    return "\n".join(lines)


@dataclass
class KernelTimer:
    """Cumulative wall clock and call count per labelled region."""

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)
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
                self.counts[label] = self.counts.get(label, 0) + 1

    def reset(self) -> None:
        with self._lock:
            self.totals.clear()
            self.counts.clear()

    def report(self) -> str:
        """One line a region, the costliest first."""
        with self._lock:
            rows = sorted(self.totals.items(), key=lambda kv: -kv[1])
            counts = dict(self.counts)
        return "\n".join(f"{label}: {total:.3f}s over {counts[label]} calls"
                         for label, total in rows)


#: process-wide prover timer: every ``marlin.prove`` and ``marlin.index``
#: adds its regions here
PROVER_TIMER = KernelTimer()


def maybe_report_prover(label: str) -> None:
    """With ``SWTPU_TRACE`` set, print the prover timer's report to stderr."""
    if os.environ.get("SWTPU_TRACE"):
        print(f"[trace] {label}\n{PROVER_TIMER.report()}", file=sys.stderr, flush=True)


@contextmanager
def device_trace(log_dir: str):
    """A ``torch.profiler`` trace of the enclosed region (the host's ops, and
    the card's kernels when there is a card), written as a Chrome/Perfetto
    trace to ``log_dir/trace.json``; yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextmanager
def maybe_profile(label: str):
    """:func:`device_trace` of the region into ``$SWTPU_TORCH_PROFILE/<label>``
    when that variable names a directory; nothing otherwise."""
    out_dir = os.environ.get("SWTPU_TORCH_PROFILE")
    if not out_dir:
        yield None
        return
    with device_trace(os.path.join(out_dir, label)) as prof:
        yield prof

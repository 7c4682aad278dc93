"""The proof pipeline: independent proofs in flight, synthesis (or
indexing) on one thread while the prove runs on another.

Port of ``simpleworks_tpu/parallel/proof_pipeline.py``: the same stage
workers, bounded queues, input-order results, abort on the first error
(re-raised to the caller) and :class:`PipelineStats`.

* **synth / index**: circuit synthesis is pure Python and holds the GIL;
  the index stage arithmetizes on the host and commits on the SRS's device.
* **prove**: the AHP rounds and KZG commits on the key's device.  The stage
  runs under its device as the thread's current CUDA device (a worker
  thread starts on card 0 whatever the caller's thread chose), so even code
  that reads the current device stays on the key's card.

How much the stages overlap is decided by the GIL.  The prove thread
releases it while it waits on the card: PyTorch's bindings drop the GIL
before an op runs, so a host fetch (``.cpu()``, ``int()`` or ``bool()`` of a
device tensor) waits for the card without it, and ``ctypes`` drops it around
every kernel-launch call.  The prove's own Python (Fiat-Shamir, the mask
draws, the launch loop) holds it, so that part and synthesis take turns;
:class:`PipelineStats` measures what overlap there was.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, Iterable, Optional

import torch

from .. import marlin

_POLL_S = 0.05
#: how long the caller waits for each worker thread to finish after the
#: results are in (or after an abort)
JOIN_TIMEOUT_S = 30.0


@dataclass
class PipelineStats:
    """Wall-clock accounting of one pipeline run."""

    wall_seconds: float = 0.0
    synth_busy_seconds: float = 0.0
    prove_busy_seconds: float = 0.0
    items: int = 0
    stage_wall: dict = field(default_factory=dict)

    @property
    def overlap_seconds(self) -> float:
        """Time both stages were busy at once: the busy sum less the wall
        time, clamped at 0."""
        return max(0.0, self.synth_busy_seconds + self.prove_busy_seconds - self.wall_seconds)

    @property
    def serial_estimate_seconds(self) -> float:
        return self.synth_busy_seconds + self.prove_busy_seconds

    @property
    def speedup(self) -> float:
        if self.wall_seconds <= 0:
            return 1.0
        return self.serial_estimate_seconds / self.wall_seconds


def _put(q: queue.Queue, item, abort: threading.Event) -> bool:
    while not abort.is_set():
        try:
            q.put(item, timeout=_POLL_S)
            return True
        except queue.Full:
            continue
    return False


def _get(q: queue.Queue, abort: threading.Event):
    """-> (ok, item); ok=False means the pipeline aborted."""
    while not abort.is_set():
        try:
            return True, q.get(timeout=_POLL_S)
        except queue.Empty:
            continue
    return False, None


def _on(device: torch.device):
    """The thread's current CUDA device set to ``device`` for the block (a
    no-op off the card)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _StageWorker(threading.Thread):
    """Pull (index, payload) from ``inbox``, apply ``fn``, push to ``outbox``.
    ``None`` is the shutdown sentinel (forwarded downstream).  The first
    exception sets ``abort`` and is re-raised by the caller."""

    def __init__(self, name, fn, inbox, outbox, errors, abort):
        super().__init__(name=f"proof-pipeline-{name}", daemon=True)
        self.fn = fn
        self.inbox = inbox
        self.outbox = outbox
        self.errors = errors
        self.abort = abort
        self.busy_seconds = 0.0

    def run(self):
        while True:
            ok, item = _get(self.inbox, self.abort)
            if not ok:
                return
            if item is None:
                _put(self.outbox, None, self.abort)
                return
            idx, payload = item
            t0 = time.perf_counter()
            try:
                result = self.fn(payload)
            except BaseException as exc:  # noqa: BLE001 — surfaced to the caller
                self.errors.append(exc)
                self.abort.set()
                return
            finally:
                self.busy_seconds += time.perf_counter() - t0
            if not _put(self.outbox, (idx, result), self.abort):
                return


def run_pipeline(
    items: Iterable,
    stages: list[tuple[str, Callable]],
    max_in_flight: int = 3,
) -> tuple[list, PipelineStats]:
    """Run ``items`` through ``stages`` (name, fn) with one worker thread a
    stage and bounded queues.  Returns (results in input order, stats).  The
    first stage exception aborts the whole pipeline and is re-raised; every
    thread is joined with a bound (``JOIN_TIMEOUT_S``) before this returns
    or raises, and a thread still alive after it is an error."""
    items = list(items)
    stats = PipelineStats(items=len(items))
    if not items:
        return [], stats
    errors: list[BaseException] = []
    abort = threading.Event()
    queues = [queue.Queue(maxsize=max_in_flight) for _ in range(len(stages) + 1)]
    workers = [
        _StageWorker(name, fn, queues[i], queues[i + 1], errors, abort)
        for i, (name, fn) in enumerate(stages)
    ]
    t0 = time.perf_counter()
    for w in workers:
        w.start()

    def feed():
        for i, item in enumerate(items):
            if not _put(queues[0], (i, item), abort):
                return
        _put(queues[0], None, abort)

    feeder = threading.Thread(target=feed, name="proof-pipeline-feed", daemon=True)
    feeder.start()

    results: list = [None] * len(items)
    done = 0
    while done < len(items):
        ok, item = _get(queues[-1], abort)
        if not ok or item is None:
            break
        idx, result = item
        results[idx] = result
        done += 1
    abort.set()  # releases any thread still blocked on a queue
    threads = [feeder, *workers]
    for t in threads:
        t.join(timeout=JOIN_TIMEOUT_S)
    stats.wall_seconds = time.perf_counter() - t0
    for (name, _fn), w in zip(stages, workers):
        stats.stage_wall[name] = w.busy_seconds
    if len(stages) >= 2:
        stats.synth_busy_seconds = workers[0].busy_seconds
        stats.prove_busy_seconds = sum(w.busy_seconds for w in workers[1:])
    if errors:
        raise errors[0]
    stuck = [t.name for t in threads if t.is_alive()]
    if stuck:
        raise RuntimeError(f"pipeline threads still running after {JOIN_TIMEOUT_S} s: {stuck}")
    return results, stats


def prove_stream(
    pk,
    synthesize_fns: Iterable[Callable[[], object]],
    max_in_flight: int = 3,
    rng_factory: Optional[Callable[[], object]] = None,
    with_stats: bool = False,
):
    """Prove a stream of independent circuits against one proving key,
    synthesis (Python) pipelined against the prove (on the key's device).

    ``synthesize_fns``: callables returning a synthesized ConstraintSystem.
    ``rng_factory``: each proof's zero-knowledge randomness (default: the
    deterministic test rng, as ``marlin.prove`` draws it).  Returns the
    proofs in input order; with ``with_stats=True`` returns ``(proofs,
    PipelineStats)``.
    """
    device = pk.srs.device

    def synth(fn):
        return fn()

    def prove(cs):
        rng = rng_factory() if rng_factory is not None else None
        with _on(device):
            return marlin.prove(pk, cs, rng)

    results, stats = run_pipeline(
        list(synthesize_fns),
        [("synth", synth), ("prove", prove)],
        max_in_flight=max_in_flight,
    )
    return (results, stats) if with_stats else results


def prove_indexed_stream(
    srs,
    circuits: Iterable,
    max_in_flight: int = 3,
    rng_factory: Optional[Callable[[], object]] = None,
    verify: bool = True,
    with_stats: bool = False,
):
    """Index, prove (and verify) a stream of synthesized circuits against one
    SRS, pipelined: the index stage (host arithmetization, memoized per
    circuit shape by ``marlin.index``, and the index commits) overlaps with
    the prove stage, both on the SRS's device.

    The prove half of block validation (``State.validate_block(prove=True)``;
    the reference proves each transaction serially inside
    ``Transaction::validate``, examples/simple-payments/transaction.rs:89-139).
    The verify leg's public inputs are each circuit's instance assignment
    without the leading One.  Returns ``(proof, verify_ok)`` pairs in input
    order.
    """
    device = srs.device

    def index_stage(cs):
        with _on(device):
            pk, vk = marlin.index(srs, cs)
        return cs, pk, vk

    def prove_stage(item):
        cs, pk, vk = item
        rng = rng_factory() if rng_factory is not None else None
        with _on(device):
            proof = marlin.prove(pk, cs, rng)
        ok = True
        if verify:
            ok = marlin.verify(vk, list(cs.instance_assignment[1:]), proof)
        return proof, ok

    results, stats = run_pipeline(
        list(circuits),
        [("index", index_stage), ("prove", prove_stage)],
        max_in_flight=max_in_flight,
    )
    return (results, stats) if with_stats else results

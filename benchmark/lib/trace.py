"""Reduce a torch.profiler trace of a run's window to what the per-layer
metrics and the result line read: the devices' busy seconds, their time by
operation name, the kernels they ran, and their idle gaps by what the host
was doing."""

from __future__ import annotations

import heapq
from collections import defaultdict
from dataclasses import dataclass, field

#: the span the harness opens around the measured window
WINDOW_SPAN = "bench.window"
#: entries kept in each list of the result line's breakdown
TOP = 10


@dataclass
class TraceSummary:
    window_s: float                 # the traced window (the window span)
    busy_s: float                   # union of a device's intervals inside it, mean of devices
    device_s: float                 # sum of device operation durations inside it
    kernels: int                    # device operations inside it that are kernels
    device_ops: dict[str, float] = field(default_factory=dict)   # seconds by name
    idle_gaps: dict[str, float] = field(default_factory=dict)    # seconds by host activity

    def breakdown(self) -> dict:
        def top(d):
            return [[name, s] for name, s in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
        return {"device_ops": top(self.device_ops), "idle_gaps": top(self.idle_gaps)}


def _events(prof):
    """(name, is_device, start_ns, end_ns, device index) of every event of
    the trace."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append((e.name(), e.device_type() != DeviceType.CPU, start, start + e.duration_ns(),
                    e.device_index()))
    return out


def is_kernel(name: str) -> bool:
    """A device operation that is a kernel: the profiler names copies
    ``Memcpy ...`` and fills ``Memset ...``."""
    return not name.startswith(("Memcpy", "Memset"))


def _union(intervals) -> list[list[int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(prof, spans: set[str], count: int = 1) -> TraceSummary | None:
    """The summary of the window span's interval over ``count`` devices;
    None when the trace holds no window span or no device operation in it.
    ``spans`` names the host spans (record_function labels) that describe
    what the host was doing."""
    events = _events(prof)
    # the profiler mirrors each host span on the device's timeline as an
    # annotation that covers the work launched under it: not an operation
    annotations = set(spans) | {WINDOW_SPAN}
    events = [ev for ev in events if not (ev[1] and ev[0] in annotations)]
    windows = [(s, e) for name, dev, s, e, _ in events if not dev and name == WINDOW_SPAN]
    if not windows:
        return None
    w0, w1 = windows[0]
    device = sorted((max(s, w0), min(e, w1), name, index) for name, dev, s, e, index in events
                    if dev and e > w0 and s < w1)
    if not device:
        return None
    device_ops: dict[str, float] = defaultdict(float)
    for s, e, name, _ in device:
        device_ops[name[:80]] += (e - s) / 1e9
    busy_ns = sum(e - s for index in {d[3] for d in device}
                  for s, e in _union((s, e) for s, e, _, i in device if i == index)) / count
    merged = _union((s, e) for s, e, _, _ in device)
    gaps, cursor = [], w0
    for s, e in merged:
        if s > cursor:
            gaps.append((cursor, s))
        cursor = max(cursor, e)
    if w1 > cursor:
        gaps.append((cursor, w1))
    host = sorted((s, e, name) for name, dev, s, e, _ in events
                  if not dev and name != WINDOW_SPAN and e > w0 and s < w1)
    idle: dict[str, float] = defaultdict(float)
    span_at = _innermost([h for h in host if h[2] in spans], gaps)
    op_at = _innermost([h for h in host if h[2] not in spans], gaps)
    for (g0, g1), span, op in zip(gaps, span_at, op_at):
        idle[f"{span or 'outside spans'} / {op or 'python'}"[:80]] += (g1 - g0) / 1e9
    return TraceSummary(window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
                        device_s=sum(device_ops.values()),
                        kernels=sum(is_kernel(name) for _, _, name, _ in device),
                        device_ops=dict(device_ops),
                        idle_gaps=dict(idle))


def _innermost(host, gaps) -> list[str | None]:
    """For each gap, the name of the latest-starting host event that covers
    the gap's midpoint (``host`` sorted by start, ``gaps`` in order)."""
    out, heap, i = [], [], 0
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        while i < len(host) and host[i][0] <= mid:
            s, e, name = host[i]
            heapq.heappush(heap, (-s, e, name))
            i += 1
        while heap and heap[0][1] <= mid:
            heapq.heappop(heap)
        # entries under the top may have ended; the top itself covers mid
        out.append(heap[0][2] if heap else None)
    return out

"""What the metric readers (``benchmark/metrics/<metric>.py``) compute, one
function a quantity; a metric's file names the function it reads with.
Each returns None where the run has nothing to read."""

from __future__ import annotations

import statistics

from .work import DEFAULT_SM_CLOCK_MHZ, msm_least_ms


def p95(values: list[float]) -> float:
    """The 95th percentile (statistics' exclusive method)."""
    return statistics.quantiles(values, n=20)[-1] if len(values) > 1 else values[0]


def setup_s(run):
    """The harness's first line to the first timed request, seconds."""
    return run.setup_s


def per_request_ms(run):
    """The window's seconds over the requests completed in it, ms."""
    return run.window_s * 1e3 / run.completed if run.completed else None


def per_request_s(run):
    return run.window_s / run.completed if run.completed else None


def p95_ms(run):
    """The 95th percentile of every request's latency in the window, ms."""
    return p95(run.latencies_s) * 1e3 if run.latencies_s else None


def device_ms(run):
    """The device's time of every kernel, copy and fill in the traced window
    over the requests completed in it, ms."""
    if run.trace is None or not run.completed or run.trace.device_s <= 0:
        return None
    return run.trace.device_s * 1e3 / run.completed


def msm_roofline(run):
    """The least time of one commit's MSM over its device time, percent."""
    measured = device_ms(run)
    if measured is None:
        return None
    least, _ = msm_least_ms(int(run.mix["width"]), run.clock_mhz or DEFAULT_SM_CLOCK_MHZ)
    return least / measured * 100.0


def launches(run):
    """The program's kernel launches (``LAUNCHES``, summed over kernel
    names; PyTorch's own kernels are not counted) a request."""
    return sum(run.launches.values()) / run.completed if run.completed else None


def kernels(run):
    """Every kernel the card ran in the traced window (the program's and
    PyTorch's alike; copies and fills not counted) a request."""
    if run.trace is None or not run.completed:
        return None
    return run.trace.kernels / run.completed


def idle_pct(run):
    """The share of the traced window in which no kernel, copy or fill ran
    on a card (the mean over the cell's cards), percent."""
    if run.trace is None or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.busy_s / run.trace.window_s)


def _span_seconds(run, keep):
    if not run.completed:
        return None
    total = sum(s for label, s in run.spans.items() if keep(label))
    return total / run.completed if total else None


def host_prework_s(run):
    """The prover's ``host.*`` regions a proof, seconds."""
    return _span_seconds(run, lambda label: label.startswith("host."))


def ahp_s(run):
    """The AHP rounds and the evaluations a proof, seconds."""
    return _span_seconds(run, lambda label: label.startswith("ahp.") or label == "evaluations")


def kzg_s(run):
    """The commitments and openings inside a prove (``kzg.*``) a proof, seconds."""
    return _span_seconds(run, lambda label: label.startswith("kzg."))

"""msm_buckets_ms: the MSM's buckets (the msm.accumulate and msm.combine spans
of PROVER_TIMER, every pass's) a commit, synchronised, ms."""

from benchmark.lib.readers import _span_seconds


def read(run):
    seconds = _span_seconds(run, lambda label: label in ("msm.accumulate", "msm.combine"))
    return None if seconds is None else seconds * 1e3

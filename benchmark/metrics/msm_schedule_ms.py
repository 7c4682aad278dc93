"""msm_schedule_ms: the MSM's schedule (the msm.digits and msm.grid spans of
PROVER_TIMER: standard form, digits, bucket counts and the stats fetch; each
pass's sort and grid) a commit, synchronised, ms."""

from benchmark.lib.readers import _span_seconds


def read(run):
    seconds = _span_seconds(run, lambda label: label in ("msm.digits", "msm.grid"))
    return None if seconds is None else seconds * 1e3

"""ahp_s: the AHP rounds and the evaluations (ahp.round1..3, evaluations of
PROVER_TIMER) a proof, synchronised, seconds."""

from benchmark.lib.readers import ahp_s as read  # noqa: F401

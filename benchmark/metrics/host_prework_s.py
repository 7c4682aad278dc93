"""host_prework_s: the prover's host.* regions of PROVER_TIMER (satisfiability,
matrices, device index, mask draws) a proof, synchronised, seconds."""

from benchmark.lib.readers import host_prework_s as read  # noqa: F401

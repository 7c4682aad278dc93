"""prove_s: the window's seconds over the proofs completed in it."""

from benchmark.lib.readers import per_request_s as read  # noqa: F401

"""kzg_s.prove: the commitments and openings inside a prove (kzg.* of
PROVER_TIMER) a proof, synchronised, seconds."""

from benchmark.lib.readers import kzg_s as read  # noqa: F401

"""RandomOracle trait surface (reference ``src/schnorr_signature/blake2s.rs``
and the vendored copy in examples/simple-payments/random_oracle/):
a Blake2s-256 oracle with native and in-circuit evaluation.

Port of ``simpleworks_tpu/schnorr/random_oracle.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..hash.blake2s import blake2s_digest
from ..r1cs.constraint_system import ConstraintSystem
from .blake2s_gadget import blake2s_gadget


class RO:
    """Native random oracle (reference blake2s.rs:43-60)."""

    @staticmethod
    def setup(_rng=None) -> None:
        return None

    @staticmethod
    def evaluate(_params, data: bytes) -> bytes:
        return blake2s_digest(data)


class ROGadget:
    """In-circuit random oracle (reference blake2s.rs:65-86)."""

    @staticmethod
    def evaluate(cs: ConstraintSystem, _params, input_bytes) -> list:
        return blake2s_gadget(cs, input_bytes)

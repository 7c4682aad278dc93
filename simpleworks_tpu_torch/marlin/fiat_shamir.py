"""Fiat-Shamir transcript RNG: Blake2s-seeded ChaCha20
(the ``SimpleHashFiatShamirRng<Blake2s, ChaChaRng>`` slot, reference
``src/marlin/mod.rs:13``).

* initialize(input): seed = Blake2s(input); rng = ChaCha20Rng(seed)
* absorb(input): seed = Blake2s(input || seed); rng reseeded
* squeeze_field_element: arkworks ``Fr::rand`` over the rng (Montgomery-repr
  rejection sampling) — deterministic for both prover and verifier.
"""

from __future__ import annotations

from ..fields.bls12_377 import Fr
from ..hash.blake2s import blake2s_digest
from ..utils.rng import chacha20_rng


class FiatShamirRng:
    def __init__(self, initial_input: bytes):
        self.seed = blake2s_digest(initial_input)
        self.rng = chacha20_rng(self.seed)

    def absorb(self, new_input: bytes) -> None:
        self.seed = blake2s_digest(bytes(new_input) + self.seed)
        self.rng = chacha20_rng(self.seed)

    def squeeze_field_element(self) -> int:
        return Fr.rand(self.rng).value

    def squeeze_field_elements(self, n: int) -> list[int]:
        return [self.squeeze_field_element() for _ in range(n)]

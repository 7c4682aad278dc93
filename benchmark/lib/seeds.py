"""Streams drawn from a run's ``--seed``: each purpose gets its own, so
that the same seed gives the same inputs and one stream's length never
shifts another's."""

from __future__ import annotations

import hashlib

import numpy as np


def derive(seed: int, purpose: str) -> int:
    """A 64-bit integer for ``purpose`` under ``seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little")


def seed_bytes(seed: int, purpose: str) -> bytes:
    """32 bytes for ``purpose`` under ``seed`` (a ChaCha key)."""
    return hashlib.sha256(f"{int(seed)}:{purpose}:key".encode()).digest()


class WordStream:
    """u64 words drawn from ``seed`` for ``purpose``: the interface
    arkworks' uniform sampling reads (``next_u64``).  The plain reference
    builds the same stream to know what was drawn."""

    def __init__(self, seed: int, purpose: str):
        self._gen = np.random.Generator(np.random.PCG64(derive(seed, purpose)))

    def next_u64(self) -> int:
        return int(self._gen.integers(0, 1 << 64, dtype=np.uint64))

    def integers(self, low: int, high: int, size: int) -> list[int]:
        return [int(v) for v in self._gen.integers(low, high, size=size)]

    def bytes(self, n: int) -> bytes:
        return self._gen.bytes(n)

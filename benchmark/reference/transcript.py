"""Marlin's Fiat-Shamir transcript (ark-marlin's SimpleHashFiatShamirRng
over Blake2s and ChaCha20): seed = Blake2s(input), then Blake2s(new input ||
seed) at each absorb; field elements are arkworks' uniform Fr sampling over
the ChaCha20 key stream (rand_core's word order, zero nonce)."""

from __future__ import annotations

import hashlib

from .field import sample_fr

MASK32 = 0xFFFFFFFF
_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _rotl(v: int, n: int) -> int:
    return ((v << n) | (v >> (32 - n))) & MASK32


def _quarter(x: list[int], a: int, b: int, c: int, d: int) -> None:
    x[a] = (x[a] + x[b]) & MASK32
    x[d] = _rotl(x[d] ^ x[a], 16)
    x[c] = (x[c] + x[d]) & MASK32
    x[b] = _rotl(x[b] ^ x[c], 12)
    x[a] = (x[a] + x[b]) & MASK32
    x[d] = _rotl(x[d] ^ x[a], 8)
    x[c] = (x[c] + x[d]) & MASK32
    x[b] = _rotl(x[b] ^ x[c], 7)


def chacha20_block(key: bytes, counter: int) -> list[int]:
    """One ChaCha20 block: 16 words, 64-bit block counter, zero nonce."""
    init = [*_CONSTANTS, *(int.from_bytes(key[4 * i : 4 * i + 4], "little") for i in range(8)),
            counter & MASK32, counter >> 32, 0, 0]
    x = list(init)
    for _ in range(10):
        _quarter(x, 0, 4, 8, 12)
        _quarter(x, 1, 5, 9, 13)
        _quarter(x, 2, 6, 10, 14)
        _quarter(x, 3, 7, 11, 15)
        _quarter(x, 0, 5, 10, 15)
        _quarter(x, 1, 6, 11, 12)
        _quarter(x, 2, 7, 8, 13)
        _quarter(x, 3, 4, 9, 14)
    return [(a + b) & MASK32 for a, b in zip(x, init)]


class ChaCha20:
    def __init__(self, key: bytes):
        self.key = key
        self.counter = 0
        self.words: list[int] = []

    def next_u32(self) -> int:
        if not self.words:
            self.words = chacha20_block(self.key, self.counter)
            self.counter += 1
        return self.words.pop(0)

    def next_u64(self) -> int:
        lo = self.next_u32()
        return (self.next_u32() << 32) | lo


class Transcript:
    def __init__(self, initial: bytes):
        self.seed = hashlib.blake2s(initial).digest()
        self.rng = ChaCha20(self.seed)

    def absorb(self, data: bytes) -> None:
        self.seed = hashlib.blake2s(bytes(data) + self.seed).digest()
        self.rng = ChaCha20(self.seed)

    def squeeze(self) -> int:
        return sample_fr(self.rng.next_u64)

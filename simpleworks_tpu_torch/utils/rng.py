"""Deterministic RNG stack replicating the reference's randomness sources.

The reference library (`lambdaclass/simpleworks`) derives *all* randomness from
``ark_std::test_rng()`` (see reference ``src/marlin/mod.rs:33-35``,
``src/hash/mod.rs:24``, ``src/merkle_tree/simple_merkle_tree.rs:38``), which is
rand 0.8's ``StdRng`` — a ChaCha12 stream cipher RNG — seeded with a fixed
32-byte seed.  The Marlin Fiat-Shamir transcript additionally uses a ChaCha20
RNG (reference ``src/marlin/mod.rs:13``: ``SimpleHashFiatShamirRng<Blake2s,
ChaChaRng>``).

This module implements both ChaCha variants with the exact word-stream
semantics of ``rand_core``'s ``BlockRng`` so that the sampled streams are
reproducible and, where our reconstruction of arkworks' sampling logic is
accurate, bit-exact with the reference.

Implementation notes
--------------------
* ``rand_chacha``'s buffer holds 4 consecutive ChaCha blocks (64 u32 words);
  output order equals sequential block generation.
* ``next_u64`` = ``lo | hi << 32`` from two consecutive u32 words, with the
  documented straddle behaviour when only one word remains in the buffer.
* ``fill_bytes`` consumes whole u32 words (little-endian), discarding unused
  trailing bytes of the final word.
"""

from __future__ import annotations

MASK32 = 0xFFFFFFFF

# Fixed seed of ark_std::test_rng() (ark-std 0.3, src/rand_helper.rs).
ARK_TEST_RNG_SEED = bytes(
    [1, 0, 0, 0, 23, 0, 0, 0, 200, 1, 0, 0, 210, 30, 0, 0,
     0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0]
)

_CHACHA_CONSTANTS = (0x61707865, 0x3320646E, 0x79622D32, 0x6B206574)


def _quarter_round(state: list[int], a: int, b: int, c: int, d: int) -> None:
    x = state
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 16) | (x[d] >> 16)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 12) | (x[b] >> 20)) & MASK32
    x[a] = (x[a] + x[b]) & MASK32
    x[d] ^= x[a]
    x[d] = ((x[d] << 8) | (x[d] >> 24)) & MASK32
    x[c] = (x[c] + x[d]) & MASK32
    x[b] ^= x[c]
    x[b] = ((x[b] << 7) | (x[b] >> 25)) & MASK32


def _chacha_block(key_words: tuple[int, ...], counter: int, rounds: int) -> list[int]:
    """One ChaCha block with a 64-bit block counter (words 12/13) and zero nonce."""
    initial = [
        *_CHACHA_CONSTANTS,
        *key_words,
        counter & MASK32,
        (counter >> 32) & MASK32,
        0,
        0,
    ]
    x = list(initial)
    for _ in range(rounds // 2):
        _quarter_round(x, 0, 4, 8, 12)
        _quarter_round(x, 1, 5, 9, 13)
        _quarter_round(x, 2, 6, 10, 14)
        _quarter_round(x, 3, 7, 11, 15)
        _quarter_round(x, 0, 5, 10, 15)
        _quarter_round(x, 1, 6, 11, 12)
        _quarter_round(x, 2, 7, 8, 13)
        _quarter_round(x, 3, 4, 9, 14)
    return [(xi + ii) & MASK32 for xi, ii in zip(x, initial)]


def _chacha_blocks_np(key_words: tuple[int, ...], counter0: int, nblocks: int, rounds: int):
    """``nblocks`` consecutive ChaCha blocks, vectorized over the block axis
    with numpy uint32 (bit-exact vs ``_chacha_block``).  Returns a flat
    uint32 array of length 16*nblocks in stream order."""
    import numpy as np

    counters = counter0 + np.arange(nblocks, dtype=np.uint64)
    x = np.empty((16, nblocks), dtype=np.uint32)
    for i, c in enumerate(_CHACHA_CONSTANTS):
        x[i, :] = c
    for i, k in enumerate(key_words):
        x[4 + i, :] = k
    x[12, :] = (counters & 0xFFFFFFFF).astype(np.uint32)
    x[13, :] = (counters >> np.uint64(32)).astype(np.uint32)
    x[14, :] = 0
    x[15, :] = 0
    initial = x.copy()

    def qr(a, b, c, d):
        x[a] += x[b]
        x[d] ^= x[a]
        x[d] = (x[d] << np.uint32(16)) | (x[d] >> np.uint32(16))
        x[c] += x[d]
        x[b] ^= x[c]
        x[b] = (x[b] << np.uint32(12)) | (x[b] >> np.uint32(20))
        x[a] += x[b]
        x[d] ^= x[a]
        x[d] = (x[d] << np.uint32(8)) | (x[d] >> np.uint32(24))
        x[c] += x[d]
        x[b] ^= x[c]
        x[b] = (x[b] << np.uint32(7)) | (x[b] >> np.uint32(25))

    old = np.seterr(over="ignore")
    try:
        for _ in range(rounds // 2):
            qr(0, 4, 8, 12)
            qr(1, 5, 9, 13)
            qr(2, 6, 10, 14)
            qr(3, 7, 11, 15)
            qr(0, 5, 10, 15)
            qr(1, 6, 11, 12)
            qr(2, 7, 8, 13)
            qr(3, 4, 9, 14)
        x += initial
    finally:
        np.seterr(**old)
    return x.T.reshape(-1)  # [block, word] -> stream order


def keystream_words(key_words: tuple[int, ...], rounds: int, start: int, count: int):
    """Words ``start .. start + count`` of the keystream (numpy uint32): the
    blocks they fall in, made with the vectorized kernel, then cut."""
    first, skip = divmod(start, 16)
    nblocks = (skip + count + 15) // 16
    return _chacha_blocks_np(key_words, first, nblocks, rounds)[skip : skip + count]


class ChaChaRng:
    """ChaCha-based RNG with rand_core ``BlockRng`` word-stream semantics.

    Every consumer (``next_u32``, ``next_u64`` including its straddle case,
    ``fill_bytes``) takes strictly consecutive words of the keystream, so the
    internal buffer size is unobservable; blocks are generated in bulk with
    the vectorized numpy kernel."""

    BUFFER_BLOCKS = 4  # minimum refill granularity (rand_chacha uses 4 blocks)

    def __init__(self, seed: bytes, rounds: int):
        if len(seed) != 32:
            raise ValueError("ChaCha seed must be 32 bytes")
        self.rounds = rounds
        self.key_words = tuple(
            int.from_bytes(seed[4 * i: 4 * i + 4], "little") for i in range(8)
        )
        self.block_counter = 0
        self.buffer = None  # numpy uint32 array
        self.index = 0

    def _remaining(self) -> int:
        return 0 if self.buffer is None else len(self.buffer) - self.index

    def _refill(self, min_words: int = 1) -> None:
        nblocks = max(self.BUFFER_BLOCKS, (min_words + 15) // 16)
        self.buffer = _chacha_blocks_np(
            self.key_words, self.block_counter, nblocks, self.rounds
        )
        self.block_counter += nblocks
        self.index = 0

    def take_words(self, n: int):
        """The next ``n`` keystream u32 words as a numpy array."""
        import numpy as np

        rem = self._remaining()
        if rem >= n:
            out = self.buffer[self.index : self.index + n]
            self.index += n
            return out
        parts = []
        if rem:
            parts.append(self.buffer[self.index :])
        self._refill(n - rem)
        parts.append(self.take_words(n - rem))
        return np.concatenate(parts) if len(parts) > 1 else parts[0]

    def unget(self, words) -> None:
        """Re-queue keystream words (most-recently-taken first in ``words``
        stream order) so the next consumer sees them again."""
        import numpy as np

        rem = (
            self.buffer[self.index :]
            if self.buffer is not None
            else np.empty(0, dtype=np.uint32)
        )
        self.buffer = np.concatenate([np.asarray(words, dtype=np.uint32), rem])
        self.index = 0

    @property
    def word_position(self) -> int:
        """The keystream index of the next word a consumer gets (the buffer
        always holds the stream up to the counter's block, ``unget``
        included)."""
        return self.block_counter * 16 - self._remaining()

    def skip_words(self, n: int) -> None:
        """Moves on ``n`` words, as ``take_words(n)`` would, without making
        the words passed over: only the blocks from the one the new position
        falls in are made again.  A draw that read the stream elsewhere from
        ``word_position`` hands the stream back here."""
        if n < 0:
            raise ValueError("cannot skip a negative number of words")
        if n <= self._remaining():
            self.index += n
            return
        block, offset = divmod(self.word_position + n, 16)
        self.buffer, self.index, self.block_counter = None, 0, block
        if offset:
            self._refill()
            self.index = offset

    def next_u32(self) -> int:
        if self._remaining() == 0:
            self._refill()
        value = int(self.buffer[self.index])
        self.index += 1
        return value

    def next_u64(self) -> int:
        lo = self.next_u32()
        hi = self.next_u32()
        return (hi << 32) | lo

    def fill_bytes(self, n: int) -> bytes:
        """Fill ``n`` bytes, consuming whole little-endian u32 words
        (rand_core ``fill_via_u32_chunks`` semantics)."""
        words = self.take_words((n + 3) // 4)
        return words.astype("<u4").tobytes()[:n]

    # rand 0.8 `Standard` distribution samples used by arkworks ----------

    def gen_bool(self) -> bool:
        """rand 0.8 `Standard` for bool: sign bit of next_u32."""
        return (self.next_u32() & 0x80000000) != 0

    def gen_u8(self) -> int:
        return self.next_u32() & 0xFF

    def gen_range_u64(self, low: int, high: int) -> int:
        """Uniform integer in [low, high) via rand 0.8's widening-multiply
        rejection method (``UniformInt::<u64>::sample_single``):
        zone = (range << range.leading_zeros()) - 1; accept when the low
        64 bits of v*range fall in the zone."""
        range_ = high - low
        if range_ <= 0:
            raise ValueError("empty range")
        leading_zeros = 64 - range_.bit_length()
        zone = ((range_ << leading_zeros) - 1) & (2**64 - 1)
        while True:
            v = self.next_u64()
            m = v * range_
            hi, lo = m >> 64, m & (2**64 - 1)
            if lo <= zone:
                return low + hi


def chacha12_rng(seed: bytes) -> ChaChaRng:
    """rand 0.8 ``StdRng`` (= ``ChaCha12Rng``) from a 32-byte seed."""
    return ChaChaRng(seed, rounds=12)


def chacha20_rng(seed: bytes) -> ChaChaRng:
    """``rand_chacha::ChaChaRng`` (= ``ChaCha20Rng``) from a 32-byte seed."""
    return ChaChaRng(seed, rounds=20)


def test_rng() -> ChaChaRng:
    """Replica of ``ark_std::test_rng()`` — the fixed-seed StdRng used for
    every sampling operation in the reference (SRS, CRH params, keygen)."""
    return chacha12_rng(ARK_TEST_RNG_SEED)


# keep pytest from collecting the imported name as a test function
test_rng.__test__ = False  # type: ignore[attr-defined]

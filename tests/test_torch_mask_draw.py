"""The Marlin mask drawn in Montgomery limbs (ops/mask_draw.py) held against
the host draw it replaces: ``Fr.rand_vec(rng, 3n)``, the fix-up
coeffs[0] = −(coeffs[n] + coeffs[2n]), then ``dvec.from_ints``, limb for
limb, with the rng left on the same word.  ``Fr.rand_vec`` is the oracle
(tests/test_torch_fields.py holds it to the JAX package's)."""

import os

import numpy as np
import pytest
import torch

from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import Fr
from simpleworks_tpu_torch.ops import mask_draw as md
from simpleworks_tpu_torch.ops._build import LAUNCHES
from simpleworks_tpu_torch.utils.rng import ChaChaRng, _chacha_blocks_np, keystream_words

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # small tensors: more threads only contend with the other test workers

SEED = bytes(range(7, 39))
#: words taken before the draw: on and off an attempt's and a block's edges,
#: and a draw right after an unget
STARTS = ("0", "3", "8", "13", "unget")


def positioned(rounds: int, start: str) -> ChaChaRng:
    """A ChaCha rng of ``rounds`` rounds with ``start`` words taken (for
    "unget": 21 taken, the last 6 of them given back)."""
    rng = ChaChaRng(SEED, rounds)
    if start == "unget":
        taken = rng.take_words(21)
        rng.unget(taken[15:])
    elif int(start):
        rng.take_words(int(start))
    return rng


def host_mask(rng, n: int) -> torch.Tensor:
    """The host draw the kernel replaces, in Montgomery limbs."""
    coeffs = Fr.rand_vec(rng, 3 * n)
    coeffs[0] = -(coeffs[n] + coeffs[2 * n]) % P
    return dvec.from_ints(coeffs, CPU)


@pytest.mark.parametrize("start", STARTS)
@pytest.mark.parametrize("n", [1 << 3, 1 << 10, 1 << 12])
@pytest.mark.parametrize("rounds", [12, 20], ids=["chacha12", "chacha20"])
def test_plain_draw_matches_host_draw(rounds, n, start):
    """Equal limbs, and afterwards the same next 40 words and next Fr.rand."""
    old, new = positioned(rounds, start), positioned(rounds, start)
    before = dict(LAUNCHES)
    got = md.draw_mask(new, n, CPU)
    assert LAUNCHES == before  # the CPU route launches no kernel
    assert got.dtype == torch.int32 and got.shape == (16, 3 * n)
    assert torch.equal(got, host_mask(old, n))
    assert new.word_position == old.word_position
    assert np.array_equal(new.take_words(40), old.take_words(40))
    assert Fr.rand(new).value == Fr.rand(old).value


@pytest.mark.parametrize("n", [1 << 3, 1 << 6])
def test_plain_draw_goes_on_after_a_short_batch(monkeypatch, n):
    """Batches far too small for the mask: each goes on from the word where
    the last stopped, and the result is the host draw's."""
    monkeypatch.setattr(md, "attempts_for", lambda remaining: max(1, remaining // 3))
    old, new = positioned(12, "3"), positioned(12, "3")
    assert torch.equal(md.draw_mask(new, n, CPU), host_mask(old, n))
    assert new.word_position == old.word_position


@pytest.mark.parametrize("pair", ["cancel", "zero", "wrap", "random"])
def test_fix_up(pair):
    """Row 0 becomes −(row n + row 2n) mod p: 0 when they cancel or are both
    0 (never p), reduced when their sum passes p."""
    gen = np.random.default_rng(5)
    a = int.from_bytes(gen.bytes(32), "little") % P
    b = {"cancel": (P - a) % P, "zero": 0, "wrap": P - 1,
         "random": int.from_bytes(gen.bytes(32), "little") % P}[pair]
    if pair == "zero":
        a = 0
    n = 4
    words = gen.integers(0, 1 << 32, size=(3 * n, 8), dtype=np.uint32)
    for row, v in ((n, a), (2 * n, b)):
        words[row] = [(v >> (32 * k)) & 0xFFFFFFFF for k in range(8)]
    md.fix_up_plain(words, n)
    assert int.from_bytes(words[0].astype("<u4").tobytes(), "little") == -(a + b) % P


@pytest.mark.parametrize("taken", [0, 5, 16, 63, 64, 70])
@pytest.mark.parametrize("skip", [0, 1, 11, 16, 37, 64, 200, 1000])
def test_skip_words_equals_take_words(taken, skip):
    """skip_words(k) leaves the rng where take_words(k) does, across block
    and buffer edges, after an unget too."""
    for unget in (False, True):
        a, b = ChaChaRng(SEED, 12), ChaChaRng(SEED, 12)
        for rng in (a, b):
            if taken:
                words = rng.take_words(taken)
                if unget:
                    rng.unget(words[taken // 2 :])
        position = a.word_position
        if skip:
            a.take_words(skip)
        b.skip_words(skip)
        assert b.word_position == a.word_position == position + skip
        assert np.array_equal(b.take_words(40), a.take_words(40))


def test_keystream_words_cut_the_stream():
    blocks = _chacha_blocks_np(ChaChaRng(SEED, 20).key_words, 0, 6, 20)
    for start, count in ((0, 16), (3, 8), (13, 40), (31, 1), (16, 64)):
        got = keystream_words(ChaChaRng(SEED, 20).key_words, 20, start, count)
        assert np.array_equal(got, blocks[start : start + count])


def test_skip_words_rejects_a_negative_count():
    with pytest.raises(ValueError):
        ChaChaRng(SEED, 12).skip_words(-1)


def test_a_device_other_than_cpu_or_cuda_raises():
    with pytest.raises(ValueError):
        md.draw_mask(positioned(12, "0"), 8, "meta")

"""The Marlin prover's zero-knowledge mask drawn where it is used: one CUDA
kernel call on the card, a vectorised numpy plain version on the CPU.

arkworks' ``Fp256::rand`` (``fields/host.py`` ``Fp.rand``) draws eight
keystream words an attempt, clears the top ``repr_shave_bits`` of the last,
and keeps the attempt if it is below p.  The kept value is the element's
*Montgomery* representation, and the port's Fr layout has R = 2^256, so the
kept words split into 16-bit halves are the ``[16, B]`` Montgomery limbs
as they stand.  :func:`draw_mask` makes the 3n coefficients of the
outer-sumcheck mask (``marlin/ahp.py`` ``sample_mask_poly``) that way: the
first 3n accepted attempts from the rng's stream position, in stream order,
then ``coeffs[0] = −(coeffs[n] + coeffs[2n]) mod p``, which is linear and so
holds on the Montgomery values.  The rng then moves on by the words the draw
consumed (``ChaChaRng.skip_words``), so it ends where ``Fr.rand_vec`` would
leave it, and every later draw reads the same words.

* a CPU device goes to :func:`mask_draw_plain` (the keystream, the mask, the
  compare, the limb split and the fix-up over numpy arrays);
* a CUDA device goes to ``csrc/mask_kernels.cu`` (``swt_mask_draw``: a count
  pass and a write pass over the recomputed keystream), or the wrapper
  raises.  There is no fallback between the two.

Both test ``max(32, int(remaining · 1.9) + 8)`` attempts at a time, as
``Fr.rand_vec`` does, and go on from where they stopped until the mask is
full.  ``LAUNCHES["mask_draw"]`` counts the kernel calls: one a prove.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ..fields.device import FR, split_words
from ..utils.rng import keystream_words
from ._build import count_launch

__all__ = ["draw_mask", "mask_draw_plain", "mask_draw_cuda", "launch_draw", "fix_up_plain",
           "attempts_for"]

#: keystream words an attempt (a 256-bit repr)
ATTEMPT_WORDS = FR.n_words
#: the last word's bits kept: repr_shave_bits (3 for Fr) cleared
TOP_MASK = (1 << (32 - FR.params.repr_shave_bits)) - 1
#: attempts a block of the kernels tests (mask_kernels.cu kAttemptsPerBlock)
ATTEMPTS_PER_BLOCK = 2 * (256 - 1)
#: int64 slots of the kernels' scratch after the per-block counts
SCRATCH_EXTRA = 4

_P_WORDS = np.array(split_words(FR.p, ATTEMPT_WORDS, 32), dtype=np.uint32)


def attempts_for(remaining: int) -> int:
    """Attempts to test for ``remaining`` more values: ``Fr.rand_vec``'s
    over-draw (~1.72 attempts a value at Fr's acceptance of 0.584)."""
    return max(32, int(remaining * 1.9) + 8)


def _below_p(words: np.ndarray) -> np.ndarray:
    """[A, 8] little-endian words -> [A] bool, value < p (from the top word)."""
    below = np.zeros(len(words), dtype=bool)
    decided = np.zeros(len(words), dtype=bool)
    for k in range(ATTEMPT_WORDS - 1, -1, -1):
        below |= ~decided & (words[:, k] < _P_WORDS[k])
        decided |= words[:, k] != _P_WORDS[k]
    return below


def fix_up_plain(words: np.ndarray, n: int) -> None:
    """Row 0 of the [3n, 8] words set to −(row n + row 2n) mod p, in place
    (0 when the two cancel, never p)."""
    stride_sum = sum(int.from_bytes(words[j].astype("<u4").tobytes(), "little")
                     for j in range(n, len(words), n)) % FR.p
    words[0] = split_words(-stride_sum % FR.p, ATTEMPT_WORDS, 32)


def mask_draw_plain(key_words, rounds: int, start: int, n: int) -> tuple[torch.Tensor, int]:
    """The mask's [16, 3n] Montgomery limbs drawn from keystream word
    ``start`` of the ChaCha stream (``key_words``, ``rounds``), and the words
    it consumed."""
    count = 3 * n
    rows, filled, consumed = [], 0, 0
    while filled < count:
        remaining = count - filled
        attempts = attempts_for(remaining)
        words = keystream_words(key_words, rounds, start + consumed, ATTEMPT_WORDS * attempts)
        words = words.reshape(attempts, ATTEMPT_WORDS).copy()
        words[:, -1] &= TOP_MASK
        kept = np.flatnonzero(_below_p(words))[:remaining]
        rows.append(words[kept])
        filled += len(kept)
        last = int(kept[-1]) + 1 if filled == count else attempts
        consumed += ATTEMPT_WORDS * last
    words = np.concatenate(rows)
    fix_up_plain(words, n)
    limbs = np.ascontiguousarray(words.astype("<u4")).view("<u2").T.astype(np.int32)
    return torch.from_numpy(np.ascontiguousarray(limbs)), consumed


def launch_draw(key_words, rounds: int, start: int, attempts: int, out: torch.Tensor,
                filled: int, remaining: int, n: int) -> torch.Tensor:
    """One ``swt_mask_draw`` call on the current stream: at most
    ``attempts`` attempts from keystream word ``start`` fill columns
    ``filled`` .. of ``out`` ([16, 3n] int32 on the card), the call that
    fills the last one applying the fix-up.  Returns the scratch, whose last
    two slots hold, once the stream is synchronised, the attempts accepted
    and the words consumed."""
    from ._build import library

    slots = -(-attempts // ATTEMPTS_PER_BLOCK) + SCRATCH_EXTRA
    scratch = torch.zeros(slots, dtype=torch.int64, device=out.device)
    key = (ctypes.c_uint32 * 8)(*key_words)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream(out.device).cuda_stream
        rc = library("mask_kernels").swt_mask_draw(
            ctypes.addressof(key), rounds, start, attempts, out.data_ptr(), out.shape[1],
            filled, remaining, n, FR.p_words_ptr, FR.n0_32, FR.one_words_ptr, TOP_MASK,
            scratch.data_ptr(), slots, stream)
    if rc != 0:
        raise RuntimeError(f"mask_draw kernel launch failed with CUDA error {rc}")
    count_launch("mask_draw")
    return scratch


def mask_draw_cuda(key_words, rounds: int, start: int, n: int,
                   device: torch.device) -> tuple[torch.Tensor, int]:
    """:func:`mask_draw_plain` on the card: one :func:`launch_draw` (two
    kernels) a batch of attempts, then one fetch of the count and the words
    consumed (the only synchronisation, of the current stream)."""
    if device.type != "cuda":
        raise ValueError(f"the mask kernel runs on a CUDA device, not {device}")
    count = 3 * n
    out = torch.empty((FR.n_limbs, count), dtype=torch.int32, device=device)
    filled = consumed = 0
    while filled < count:
        remaining = count - filled
        scratch = launch_draw(key_words, rounds, start + consumed, attempts_for(remaining), out,
                              filled, remaining, n)
        kept, used = scratch[-2:].tolist()
        filled += min(kept, remaining)
        consumed += used
    return out, consumed


def draw_mask(rng, n: int, device) -> torch.Tensor:
    """The outer-sumcheck mask's [16, 3n] Montgomery limbs on ``device``,
    drawn from ``rng`` (a ``ChaChaRng``) as ``Fr.rand_vec(rng, 3n)`` and the
    fix-up would draw them; ``rng`` moves on by the words consumed."""
    device = torch.device(device)
    args = (rng.key_words, rng.rounds, rng.word_position, n)
    if device.type == "cpu":
        out, consumed = mask_draw_plain(*args)
    else:
        out, consumed = mask_draw_cuda(*args, device)
    rng.skip_words(consumed)
    return out

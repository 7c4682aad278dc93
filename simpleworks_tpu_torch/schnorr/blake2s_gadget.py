"""In-circuit Blake2s-256 (RFC 7693) over UInt32 gadgets.

Replaces ``ark_crypto_primitives::prf::blake2s::constraints::evaluate_blake2s``
(SURVEY.md §2.3 'Blake2s'; reference usage
``src/schnorr_signature/blake2s.rs:67-86``).  Additions use the one-constraint
field ``addmany``; XORs are bitwise; rotations are free bit re-wirings.

The native twin is :func:`simpleworks_tpu_torch.hash.blake2s.blake2s_digest`
(hashlib); the gadget is tested byte-for-byte against it (the reference's
RO-gadget cross-check, examples/simple-payments/random_oracle/blake2s/
constraints.rs:59-89).

Port of ``simpleworks_tpu/schnorr/blake2s_gadget.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..gadgets.boolean import Boolean
from ..gadgets.uint import UIntGadget
from ..r1cs.constraint_system import ConstraintSystem

IV = [
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
]

SIGMA = [
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15],
    [14, 10, 4, 8, 9, 15, 13, 6, 1, 12, 0, 2, 11, 7, 5, 3],
    [11, 8, 12, 0, 5, 2, 15, 13, 10, 14, 3, 6, 7, 1, 9, 4],
    [7, 9, 3, 1, 13, 12, 11, 14, 2, 6, 5, 10, 4, 0, 15, 8],
    [9, 0, 5, 7, 2, 4, 10, 15, 14, 1, 11, 12, 6, 8, 3, 13],
    [2, 12, 6, 10, 0, 11, 8, 3, 4, 13, 7, 5, 15, 14, 1, 9],
    [12, 5, 1, 15, 14, 13, 4, 10, 0, 7, 6, 3, 9, 2, 8, 11],
    [13, 11, 7, 14, 12, 1, 3, 9, 5, 0, 15, 4, 8, 6, 2, 10],
    [6, 15, 14, 9, 11, 3, 0, 8, 12, 2, 13, 7, 1, 4, 10, 5],
    [10, 2, 8, 4, 7, 6, 1, 5, 15, 11, 9, 14, 3, 12, 13, 0],
]

# parameter block word 0 for unkeyed Blake2s-256: digest 32, fanout 1, depth 1
PARAM_WORD0 = 0x01010020


def _rotr_free(word: UIntGadget, k: int) -> UIntGadget:
    """Rotation is a bit permutation — re-wire without constraints."""
    bits = word.bits  # LE
    rotated = bits[k:] + bits[:k]
    return UIntGadget.from_bits_le(32, rotated)


def _xor(a: UIntGadget, b: UIntGadget) -> UIntGadget:
    return a.xor(b)


def _add(cs, *ops: UIntGadget) -> UIntGadget:
    return UIntGadget.addmany(list(ops), cs)


def _g(cs, v, a, b, c, d, x, y):
    v[a] = _add(cs, v[a], v[b], x)
    v[d] = _rotr_free(_xor(v[d], v[a]), 16)
    v[c] = _add(cs, v[c], v[d])
    v[b] = _rotr_free(_xor(v[b], v[c]), 12)
    v[a] = _add(cs, v[a], v[b], y)
    v[d] = _rotr_free(_xor(v[d], v[a]), 8)
    v[c] = _add(cs, v[c], v[d])
    v[b] = _rotr_free(_xor(v[b], v[c]), 7)


def _compress(cs, h, block_words, t, last):
    v = list(h) + [UIntGadget.constant(cs, 32, iv) for iv in IV]
    v[12] = _xor(v[12], UIntGadget.constant(cs, 32, t & 0xFFFFFFFF))
    v[13] = _xor(v[13], UIntGadget.constant(cs, 32, (t >> 32) & 0xFFFFFFFF))
    if last:
        v[14] = _xor(v[14], UIntGadget.constant(cs, 32, 0xFFFFFFFF))
    for rnd in range(10):
        s = SIGMA[rnd]
        _g(cs, v, 0, 4, 8, 12, block_words[s[0]], block_words[s[1]])
        _g(cs, v, 1, 5, 9, 13, block_words[s[2]], block_words[s[3]])
        _g(cs, v, 2, 6, 10, 14, block_words[s[4]], block_words[s[5]])
        _g(cs, v, 3, 7, 11, 15, block_words[s[6]], block_words[s[7]])
        _g(cs, v, 0, 5, 10, 15, block_words[s[8]], block_words[s[9]])
        _g(cs, v, 1, 6, 11, 12, block_words[s[10]], block_words[s[11]])
        _g(cs, v, 2, 7, 8, 13, block_words[s[12]], block_words[s[13]])
        _g(cs, v, 3, 4, 9, 14, block_words[s[14]], block_words[s[15]])
    return [_xor(_xor(h[i], v[i]), v[i + 8]) for i in range(8)]


def blake2s_gadget(cs: ConstraintSystem, input_bytes: list[UIntGadget]) -> list[UIntGadget]:
    """Blake2s-256 over UInt8 gadgets; returns 32 output byte gadgets."""
    h = [UIntGadget.constant(cs, 32, IV[0] ^ PARAM_WORD0)] + [
        UIntGadget.constant(cs, 32, iv) for iv in IV[1:]
    ]
    data = list(input_bytes)
    n = len(data)
    zero_byte = UIntGadget.constant(cs, 8, 0)

    if n == 0:
        blocks = [[zero_byte] * 64]
        t_values = [(0, True)]
    else:
        blocks = []
        t_values = []
        offset = 0
        while offset < n:
            chunk = data[offset : offset + 64]
            is_last = offset + 64 >= n
            t = min(offset + 64, n)
            chunk = chunk + [zero_byte] * (64 - len(chunk))
            blocks.append(chunk)
            t_values.append((t, is_last))
            offset += 64

    for block, (t, last) in zip(blocks, t_values):
        words = [
            UIntGadget.from_bytes_le(32, block[4 * i : 4 * i + 4]) for i in range(16)
        ]
        h = _compress(cs, h, words, t, last)

    out_bytes: list[UIntGadget] = []
    for word in h:
        out_bytes.extend(word.to_bytes())
    return out_bytes

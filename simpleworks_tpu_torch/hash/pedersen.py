"""Pedersen CRH over ed-on-bls12-377 with twisted-Edwards compression.

Replaces ``ark_crypto_primitives::crh::{pedersen, injective_map}``
(SURVEY.md §2.3 'Pedersen CRH + TE compressor'; reference call sites
``src/hash/mod.rs:16-28``, ``src/merkle_tree/common.rs:11-30``).

* ``setup``: per window, sample a random curve point with the deterministic
  test RNG and take its first ``window_size`` doublings (arkworks
  ``generator_powers`` layout) — bit-exact RNG consumption order.
* ``evaluate``: zero-pad input to the window capacity, split LE bits into
  windows, sum the generators selected by set bits, output the affine
  x-coordinate (the ``TECompressor`` injective map).

Window shapes from the reference: leaf 4×144, two-to-one 4×128
(``src/merkle_tree/common.rs:16-29``), standalone hash 4×144
(``src/hash/mod.rs:16-19``).

Port of ``simpleworks_tpu/hash/pedersen.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.edwards import EdwardsPoint
from ..utils.rng import test_rng


@dataclass(frozen=True)
class PedersenWindow:
    window_size: int
    num_windows: int

    @property
    def capacity_bits(self) -> int:
        return self.window_size * self.num_windows


#: reference src/hash/mod.rs:16-19 and src/merkle_tree/common.rs:27-29
LEAF_WINDOW = PedersenWindow(window_size=4, num_windows=144)
#: reference src/merkle_tree/common.rs:16-18
TWO_TO_ONE_WINDOW = PedersenWindow(window_size=4, num_windows=128)


class PedersenParameters:
    __slots__ = ("window", "generators")

    def __init__(self, window: PedersenWindow, generators: list[list[EdwardsPoint]]):
        self.window = window
        self.generators = generators


def pedersen_setup(window: PedersenWindow, rng) -> PedersenParameters:
    """arkworks pedersen ``setup``: one random base per window, then its
    successive doublings (g, 2g, 4g, ...)."""
    generators = []
    for _ in range(window.num_windows):
        cur = EdwardsPoint.rand(rng)
        powers = []
        for _ in range(window.window_size):
            powers.append(cur)
            cur = cur.double()
        generators.append(powers)
    return PedersenParameters(window, generators)


def parameters_from_reference(window: PedersenWindow, coords) -> PedersenParameters:
    """The JAX package's Pedersen generators, given as nested lists of affine
    ``(x, y)`` ints (``coords[w][i]`` for window w, power i), as the port's
    :class:`PedersenParameters`, so both packages can hash with one set."""
    if len(coords) != window.num_windows or any(len(w) != window.window_size for w in coords):
        raise ValueError(f"expected {window.num_windows} windows of {window.window_size} points")
    generators = []
    for powers in coords:
        points = []
        for x, y in powers:
            if not EdwardsPoint.is_on_curve_affine(x, y):
                raise ValueError(f"({x}, {y}) is not on the curve")
            points.append(EdwardsPoint.from_affine(x, y))
        generators.append(points)
    return PedersenParameters(window, generators)


def bytes_to_bits_le(data: bytes) -> list[bool]:
    """LSB-first per byte (arkworks pedersen ``bytes_to_bits``)."""
    bits = []
    for byte in data:
        for i in range(8):
            bits.append((byte >> i) & 1 == 1)
    return bits


def pedersen_evaluate_point(params: PedersenParameters, data: bytes) -> EdwardsPoint:
    window = params.window
    if len(data) * 8 > window.capacity_bits:
        raise ValueError(
            f"input of {len(data)} bytes exceeds Pedersen window capacity "
            f"{window.capacity_bits} bits"
        )
    padded = data + b"\x00" * ((window.capacity_bits + 7) // 8 - len(data))
    bits = bytes_to_bits_le(padded)[: window.capacity_bits]
    acc = EdwardsPoint.identity()
    for w in range(window.num_windows):
        window_bits = bits[w * window.window_size : (w + 1) * window.window_size]
        for bit, base in zip(window_bits, params.generators[w]):
            if bit:
                acc = acc.add(base)
    return acc


def pedersen_evaluate(params: PedersenParameters, data: bytes) -> int:
    """CRH output: TE-compressed (x-coordinate) hash value in ConstraintF."""
    return pedersen_evaluate_point(params, data).to_affine()[0]


def pedersen_evaluate_two_to_one(params: PedersenParameters, left: bytes, right: bytes) -> int:
    """arkworks ``TwoToOneCRH::evaluate``: hash of left || right."""
    return pedersen_evaluate(params, bytes(left) + bytes(right))


def pedersen_hash(data: bytes) -> int:
    """The reference's standalone ``pedersen_hash`` (src/hash/mod.rs:23-28):
    fresh test-RNG parameters per call, window 4×144."""
    params = pedersen_setup(LEAF_WINDOW, test_rng())
    return pedersen_evaluate(params, data)

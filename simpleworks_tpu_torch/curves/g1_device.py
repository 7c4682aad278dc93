"""Batched BLS12-377 G1 arithmetic on the device, in limb-major planes.

Port of ``simpleworks_tpu/curves/g1_device.py``.  A point batch is a tuple of
three ``[24, B]`` ``torch.int32`` Fq Montgomery planes (Jacobian X, Y, Z;
Z = 0 the identity), the layout of :mod:`simpleworks_tpu_torch.ops.g1_limb`.
:func:`add` and :func:`double` are one launch of the fused Jacobian-add
kernel on CUDA tensors (``g1_limb.add``; a doubling is the complete add of a
point with itself), its plain version on CPU tensors; selects and identity
tests are plain tensor ops.

:func:`scalar_mul_fixed_base_batch` is the reference's double-free ladder:
the host doubles the base ``num_bits`` times, and the device adds
``2^b · base`` to the lanes whose scalar has bit b set, one batched add and
one select a bit.  :func:`tree_reduce` sums a batch by halving.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np
import torch

from ..device import resolve
from ..fields.bls12_377 import Fq
from ..fields.device import DeviceField
from ..ops import g1_fused, g1_limb
from .bls12_377 import G1Point


@lru_cache(maxsize=None)
def fq_device_field() -> DeviceField:
    return DeviceField(Fq.PARAMS)


def points_to_device(points: list[G1Point], device=None) -> tuple:
    """Host Jacobian points -> ([24, N],)*3 Montgomery planes on ``device``
    (the card by default)."""
    return g1_limb.points_to_limb_major(points, resolve(device))


def points_from_device(batch) -> list[G1Point]:
    """([24, N],)*3 Montgomery planes -> host Jacobian points (fetches)."""
    return g1_limb.points_from_limb_major(batch)


def identity_like(batch: int, device) -> tuple:
    """``batch`` Jacobian identities (1, 1, 0) on ``device``."""
    return g1_fused.identity(batch, device)


def is_identity(p) -> torch.Tensor:
    """[B] bool: Z == 0."""
    return fq_device_field().is_zero(p[2])


def select_point(cond: torch.Tensor, a, b) -> tuple:
    """Lanewise cond ? a : b over a [B] bool mask."""
    return g1_fused.select_point(cond, a, b)


def double(p) -> tuple:
    """2p, lanewise (the complete add of p with itself)."""
    return g1_limb.add(p, p)


def add(p, q) -> tuple:
    """Complete Jacobian addition, lanewise."""
    return g1_limb.add(p, q)


def scalar_mul_fixed_base_batch(base: G1Point, scalars: list[int], num_bits: int = 253,
                                device=None) -> tuple:
    """scalars[i]·base for every i, as ([24, N],)*3 Jacobian planes on
    ``device`` (the card by default); bits of a scalar at or above
    ``num_bits`` are ignored, as in the reference."""
    device = resolve(device)
    table, cur = [], base
    for _ in range(num_bits):
        table.append(cur)
        cur = cur.double()
    tx, ty, tz = points_to_device(table, device)  # column b: 2^b · base
    n = len(scalars)
    bits = np.zeros((num_bits, n), dtype=bool)
    for i, s in enumerate(scalars):
        s = int(s)
        for b in range(min(num_bits, s.bit_length())):
            bits[b, i] = (s >> b) & 1
    bits_t = torch.from_numpy(bits).to(device)
    acc = identity_like(n, device)
    for b in range(num_bits):
        term = (tx[:, b : b + 1].expand(-1, n), ty[:, b : b + 1].expand(-1, n),
                tz[:, b : b + 1].expand(-1, n))
        acc = select_point(bits_t[b], add(acc, term), acc)
    return acc


def tree_reduce(points) -> tuple:
    """Sum of an ([24, N],)*3 batch (N a power of two) by pairwise halving
    -> ([24, 1],)*3."""
    X, Y, Z = points
    n = X.shape[1]
    if n == 0 or n & (n - 1):
        raise ValueError(f"tree_reduce takes a power-of-two batch, got {n}")
    while n > 1:
        half = n // 2
        X, Y, Z = add((X[:, :half], Y[:, :half], Z[:, :half]),
                      (X[:, half:n], Y[:, half:n], Z[:, half:n]))
        n = half
    return X, Y, Z

"""Device fixed-base MSM: the SRS powers of tau on the card.

Port of ``simpleworks_tpu/ops/srs_device.py``.  The host builds the small
32 × 256 window table d·2^(8w)·G once (8k point adds); the device then runs
32 gather-and-add steps over all N lanes.  :func:`fixed_base_powers_device`
returns the Jacobian planes, bit for bit the reference's table;
:func:`fixed_base_powers_affine` normalises them to Z = 1 on the card with
one batched inversion (``g1_limb.normalize_affine``), the layout the MSM's
mixed adds read.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..curves.bls12_377 import G1Point
from . import g1_limb

WINDOW_BITS = 8
NUM_WINDOWS = 32  # 256 / 8
CHUNK = 1 << 19  # lanes per pass (bounds the temporaries of the composed add)


@lru_cache(maxsize=4)
def _window_table(base: G1Point) -> list[G1Point]:
    """[w*256 + d] = d · 2^(8w) · base (row 0 of each window = identity);
    8k host point adds, made once a base (every setup's base is the
    generator)."""
    table: list[G1Point] = []
    cur = base
    for _w in range(NUM_WINDOWS):
        table.append(G1Point.identity())
        acc = cur
        for _d in range(255):
            table.append(acc)
            acc = acc.add(cur)
        cur = acc  # 256 · cur — the next window's base
    return table


@lru_cache(maxsize=4)
def _table_planes(base: G1Point, device: torch.device) -> torch.Tensor:
    """:func:`_window_table` as [3, 24, 8192] Montgomery planes on ``device``."""
    return torch.stack(g1_limb.points_to_limb_major(_window_table(base), device))


def fixed_base_powers_device(base: G1Point, scalars_std: torch.Tensor):
    """out[i] = scalars[i]·base for standard-form scalars given as [16, N]
    16-bit limbs, on their device -> Jacobian ([24, N],)*3 Montgomery planes."""
    dev = scalars_std.device
    n = scalars_std.shape[1]
    table = _table_planes(base, dev)
    outs = []
    for lo in range(0, n, CHUNK):
        sc = scalars_std[:, lo : lo + CHUNK]
        acc = g1_limb.identity(sc.shape[1], dev)
        for w in range(NUM_WINDOWS):
            digit = (sc[w >> 1] >> (8 * (w & 1))) & 0xFF
            pts = table.index_select(2, (digit + 256 * w).to(torch.int64))
            acc = g1_limb.add(acc, (pts[0], pts[1], pts[2]))
        outs.append(acc)
    return tuple(torch.cat([o[k] for o in outs], dim=1) for k in range(3))


def fixed_base_powers_affine(base: G1Point, scalars_std: torch.Tensor) -> torch.Tensor:
    """As :func:`fixed_base_powers_device`, normalised on the device to the
    [2, 24, N] affine X/Y planes (Z = 1; the identity as x = y = 0)."""
    return g1_limb.normalize_affine(fixed_base_powers_device(base, scalars_std))

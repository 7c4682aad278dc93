"""Device fixed-base MSM: the SRS powers of tau on the card.

Port of ``simpleworks_tpu/ops/srs_device.py``.  The host builds the small
32 × 256 window table d·2^(8w)·G once (8k point adds); the device then
walks each lane's 32 byte digits, adding one table row a window: on the
card one launch of the fixed-base kernel over all lanes
(``g1_fused.fixed_base``), its accumulators in registers.
:func:`fixed_base_powers_device` returns the Jacobian planes, bit for bit
the reference's table; :func:`fixed_base_powers_affine` normalises them to
Z = 1 on the card with one batched inversion (``g1_limb.normalize_affine``),
the layout the MSM's mixed adds read.  :func:`fixed_base_per_window` is the
route the kernel replaced, one gather and one point-add launch a window,
kept as its baseline.
"""

from __future__ import annotations

from functools import lru_cache

import torch

from ..curves.bls12_377 import G1Point
from . import g1_fused, g1_limb

WINDOW_BITS = 8
NUM_WINDOWS = g1_fused.WINDOWS  # 256 / 8
CHUNK = 1 << 19  # lanes a pass of the per-window route (bounds its temporaries)


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


@lru_cache(maxsize=4)
def _packed_table(base: G1Point, device: torch.device) -> torch.Tensor:
    """:func:`_table_planes` as the fixed-base kernel's [8192, 36] rows of
    32-bit words (1.2 MB)."""
    return g1_fused.pack_table(_table_planes(base, device))


def fixed_base_powers_device(base: G1Point, scalars_std: torch.Tensor):
    """out[i] = scalars[i]·base for standard-form scalars given as [16, N]
    16-bit limbs (any strides), on their device -> Jacobian ([24, N],)*3
    Montgomery planes; one kernel launch on the card."""
    return g1_fused.fixed_base(_packed_table(base, scalars_std.device), scalars_std)


def fixed_base_per_window(base: G1Point, scalars_std: torch.Tensor):
    """:func:`fixed_base_powers_device` by the route the fixed-base kernel
    replaced: from the identity, a gather of each window's rows and one
    ``g1_limb.add`` of whole planes (a point-add launch on the card) a
    window, in passes of CHUNK lanes.  The same planes, bit for bit."""
    dev = scalars_std.device
    table = _table_planes(base, dev)
    outs = [g1_fused.walk_windows(table, sc, g1_limb.add, g1_limb.identity(sc.shape[1], dev))
            for sc in scalars_std.split(CHUNK, dim=1)]
    return tuple(torch.cat([o[k] for o in outs], dim=1) for k in range(3))


def fixed_base_powers_affine(base: G1Point, scalars_std: torch.Tensor) -> torch.Tensor:
    """As :func:`fixed_base_powers_device`, normalised on the device to the
    [2, 24, N] affine X/Y planes (Z = 1; the identity as x = y = 0)."""
    return g1_limb.normalize_affine(fixed_base_powers_device(base, scalars_std))

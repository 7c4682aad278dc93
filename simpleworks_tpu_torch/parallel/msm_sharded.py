"""The sharded MSM over a list of devices: the coefficient range split into
contiguous shards, each shard's MSM on its device, the partial sums added on
the host.

Port of ``simpleworks_tpu/parallel/msm_sharded.py``.  The reference runs
one SPMD Pippenger over a mesh, with every shard's window schedule made to
one common shape and the window sums tree-reduced across the mesh; here
each shard runs what an unsharded commit runs on its device
(``kzg10.device_msm``) over its slice of the SRS's affine planes: on the
card ``msm_device_mont`` (digits, one accumulate launch and one combine
launch a window group), on the CPU the same or, for a shard of at most
``kzg10.HOST_MSM_MAX_WIDTH`` coefficients, the host Pippenger.  The shards
need no common schedule, and the D partial points are added on the host.
The sum is the same group element as the unsharded MSM's.

A shard on the table's own device reads the table in place (an offset, no
copy); a shard on another device reads a copy of the whole table made once
per table and device.  The shards run one after another from one thread.
"""

from __future__ import annotations

import threading

import torch

from ..curves.bls12_377 import G1Point
from ..device import resolve
from ..fields import dvec
from ..fields.bls12_377 import FR_MODULUS
from ..kzg import kzg10
from ..ops import g1_limb
from ..ops.msm_pippenger import _check_range

#: (id of a table, device) -> (the table, its copy on the device)
_COPIES: dict = {}
_COPIES_MAX = 8
_COPIES_LOCK = threading.Lock()


def _table_on(points_xy: torch.Tensor, device: torch.device) -> torch.Tensor:
    if points_xy.device == device:
        return points_xy
    key = (id(points_xy), str(device))
    with _COPIES_LOCK:
        hit = _COPIES.get(key)
    if hit is not None and hit[0] is points_xy:
        return hit[1]
    copy = points_xy.to(device)
    with _COPIES_LOCK:
        if len(_COPIES) >= _COPIES_MAX:
            _COPIES.pop(next(iter(_COPIES)))
        _COPIES[key] = (points_xy, copy)
    return copy


def sharded_msm(devices, points_xy: torch.Tensor, coeffs: torch.Tensor,
                offset: int = 0) -> G1Point:
    """Σ coeffs[i]·P[offset + i] for the [16, n] Montgomery coefficients
    against the [2, 24, N] affine planes, over ``len(devices)`` contiguous
    shards of the coefficients (⌈n/D⌉ each, the last the rest)."""
    n = int(coeffs.shape[1])
    if n == 0:
        return G1Point.identity()
    _check_range(points_xy, n, offset)
    devices = [resolve(d) for d in devices]
    per = -(-n // len(devices))
    total = G1Point.identity()
    for k, dev in enumerate(devices):
        lo, hi = k * per, min(n, (k + 1) * per)
        if lo >= hi:
            break
        part = kzg10.device_msm(_table_on(points_xy, dev), coeffs[:, lo:hi].to(dev),
                                offset=offset + lo)
        total = total.add(part)
    return total


def sharded_msm_host(devices, points: list[G1Point], scalars: list[int]) -> G1Point:
    """Host wrapper: G1 points and int scalars in, Σ scalars[i]·points[i]
    out, sharded over ``devices`` (the inputs are packed on the first)."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points, {len(scalars)} scalars")
    device = resolve(devices[0])
    x, y, _z = g1_limb.points_to_limb_major_affine(points, device)
    coeffs = dvec.from_ints([int(s) % FR_MODULUS for s in scalars], device)
    return sharded_msm(devices, torch.stack([x, y]), coeffs)

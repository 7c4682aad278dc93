"""The sharded MSM over a list of devices: the coefficient range split into
contiguous shards, each shard's MSM on its device, the partial sums added on
the host.

Port of ``simpleworks_tpu/parallel/msm_sharded.py``.  The reference runs
one SPMD Pippenger over a mesh, with every shard's window schedule made to
one common shape and the window sums tree-reduced across the mesh; here
each shard runs what an unsharded commit runs on its device
(``kzg10.device_msm``) over its slice of the SRS's affine planes: on the
card ``msm_device_mont`` (digits, one accumulate launch and one combine
launch a window group), on the CPU the host MSM (the native runtime's).
:func:`sharded_msm_native` shards the SRS's host rows the same way (the
reference's name): a CPU shard runs the native MSM over its rows, a card
shard uploads only its rows' X/Y planes.  The shards need no common
schedule, and the D partial points are added on the host.  The sum is the
same group element as the unsharded MSM's.

A shard on the table's own device reads the table in place (an offset, no
copy); a shard on another device reads a copy of its own slice of the
table, made once per table, device and slice.  In a multi-process job
(:mod:`.multihost`) the device list is global: each rank computes only the
shards on its own devices, at the same time as the other ranks, and one
``all_gather`` of the partial points gives every rank the same sum.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

from .. import native
from ..curves.bls12_377 import G1Point
from ..device import resolve
from ..fields import dvec
from ..fields.bls12_377 import FQ_MODULUS, FR_MODULUS
from ..kzg import kzg10
from ..ops import g1_limb
from ..ops.msm_pippenger import _check_range, msm_device
from . import multihost

#: (id of a table, device, first point, end) -> (the table, its slice there)
_COPIES: dict = {}
_COPIES_MAX = 16
_COPIES_LOCK = threading.Lock()


def _slice_on(table, device: torch.device, lo: int, hi: int, make) -> torch.Tensor:
    """``make(lo, hi)`` (points lo..hi of ``table`` as [2, 24, hi − lo]
    planes on ``device``), made once per table, device and slice."""
    key = (id(table), str(device), lo, hi)
    with _COPIES_LOCK:
        hit = _COPIES.get(key)
    if hit is not None and hit[0] is table:
        return hit[1]
    copy = make(lo, hi)
    with _COPIES_LOCK:
        if len(_COPIES) >= _COPIES_MAX:
            _COPIES.pop(next(iter(_COPIES)))
        _COPIES[key] = (table, copy)
    return copy


def _table_on(points_xy: torch.Tensor, device: torch.device, lo: int, hi: int):
    """(planes, offset) of points lo..hi for a shard on ``device``: the table
    itself on its own device, else a copy of that slice only."""
    if points_xy.device == device:
        return points_xy, lo
    return _slice_on(points_xy, device, lo, hi,
                     lambda a, b: points_xy[:, :, a:b].to(device)), 0


_POINT_BYTES = 144  # X, Y, Z as 48-byte little-endian integers


def _point_to_tensor(pt: G1Point) -> torch.Tensor:
    data = b"".join(int(v).to_bytes(48, "little") for v in (pt.X, pt.Y, pt.Z))
    return torch.frombuffer(bytearray(data), dtype=torch.uint8)


def _point_from_tensor(t: torch.Tensor) -> G1Point:
    data = t.numpy().tobytes()
    x, y, z = (int.from_bytes(data[48 * k : 48 * (k + 1)], "little") for k in range(3))
    return G1Point(x % FQ_MODULUS, y % FQ_MODULUS, z % FQ_MODULUS)


def _sum_parts(parts: list) -> G1Point:
    """Σ of the shards' partial points; across processes every rank's own
    parts are gathered first (one ``all_gather``)."""
    if multihost.in_job():
        parts = [_point_from_tensor(t) for t in multihost.fetch_global(
            [None if p is None else _point_to_tensor(p) for p in parts])]
    total = G1Point.identity()
    for part in parts:
        total = total.add(part)
    return total


def _shard_bounds(n: int, shards: int):
    per = -(-n // shards)
    return [(min(n, k * per), min(n, (k + 1) * per)) for k in range(shards)]


def sharded_msm(devices, points_xy: torch.Tensor, coeffs: torch.Tensor,
                offset: int = 0) -> G1Point:
    """Σ coeffs[i]·P[offset + i] for the [16, n] Montgomery coefficients
    against the [2, 24, N] affine planes, over ``len(devices)`` contiguous
    shards of the coefficients (⌈n/D⌉ each, the last the rest); a None
    device is another rank's shard."""
    n = int(coeffs.shape[1])
    if n == 0:
        return G1Point.identity()
    _check_range(points_xy, n, offset)
    parts = []
    for dev, (lo, hi) in zip(devices, _shard_bounds(n, len(devices))):
        if dev is None:
            parts.append(None)
            continue
        dev = resolve(dev)
        if lo >= hi:
            parts.append(G1Point.identity())
            continue
        table, at = _table_on(points_xy, dev, offset + lo, offset + hi)
        parts.append(kzg10.device_msm(table, coeffs[:, lo:hi].to(dev), offset=at))
    return _sum_parts(parts)


def sharded_msm_native(devices, powers_native: np.ndarray, scalars_std: np.ndarray,
                       offset: int = 0) -> G1Point:
    """Σ scalars[i]·P[offset + i] over normalised [N, 18] host rows and
    [n, 4] standard-form scalar words, sharded over ``devices`` as
    :func:`sharded_msm`: a CPU shard runs the native batch-affine MSM on its
    rows, a card shard the device MSM on its rows' planes (uploaded once per
    table and slice)."""
    scalars_std = np.ascontiguousarray(scalars_std, dtype="<u8")
    n = scalars_std.shape[0]
    if n == 0:
        return G1Point.identity()
    if offset < 0 or offset + n > powers_native.shape[0]:
        raise ValueError(f"points {offset}..{offset + n} exceed the table of "
                         f"{powers_native.shape[0]}")
    parts = []
    for dev, (lo, hi) in zip(devices, _shard_bounds(n, len(devices))):
        if dev is None:
            parts.append(None)
            continue
        dev = resolve(dev)
        if lo >= hi:
            parts.append(G1Point.identity())
        elif dev.type == "cpu":
            parts.append(native.g1_msm_affine_arr(powers_native[offset + lo : offset + hi],
                                                  scalars_std[lo:hi]))
        else:
            planes = _slice_on(powers_native, dev, offset + lo, offset + hi,
                               lambda a, b: g1_limb.native_points_to_limb_major(
                                   powers_native[a:b], dev))
            parts.append(msm_device(planes, scalars_std[lo:hi]))
    return _sum_parts(parts)


def sharded_msm_host(devices, points: list[G1Point], scalars: list[int]) -> G1Point:
    """Host wrapper: G1 points and int scalars in, Σ scalars[i]·points[i]
    out, sharded over ``devices`` (the inputs are packed on the first)."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points, {len(scalars)} scalars")
    device = resolve(devices[0])
    x, y, _z = g1_limb.points_to_limb_major_affine(points, device)
    coeffs = dvec.from_ints([int(s) % FR_MODULUS for s in scalars], device)
    return sharded_msm(devices, torch.stack([x, y]), coeffs)

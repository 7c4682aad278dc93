"""Device Pippenger MSM over BLS12-377 G1 (the KZG commit kernel path).

Port of the default device route of ``simpleworks_tpu/ops/msm_pippenger.py``
(``msm_device_mont``):

1. **Digits on the device**: Montgomery coefficients ``[16, N]`` leave
   Montgomery form by one field multiply with the literal 1, and are cut into
   W = ⌈256/c⌉ windows of c bits.  A per-window sort and ``searchsorted``
   give the only data-dependent facts the host needs: each window's largest
   bucket occupancy and largest live digit (one [W, 2] fetch).
2. **Schedule**: windows are grouped by occupancy depth; each group becomes
   a ``[D, g·S·B]`` gather grid, built on the device from an argsort of its
   digits (column w·S·B + s·B + d lists the points whose window-w digit is
   d; digit 0 has weight 0 and owns no entries).
3. **Accumulate**: each group's D grid rows gather affine points (X, Y
   only: the SRS is normalised to Z = 1) into per-lane bucket sums.  The
   default is the Jacobian mixed add (``"madd"``): on CUDA one launch of the
   accumulate kernel a group runs all D rows with the sums in registers
   (``g1_fused.madd_accumulate``).  ``"affine"`` is a Python loop over the
   rows, each one complete batch-affine add (``g1_limb.affine_madd``, ~25
   field-kernel launches and one Fermat pow a row), the reference's TPU
   default, kept as an option and as the oracle.
4. **Bucket combine**: segment fold, then Σ_d d·S_d per window by two
   inclusive suffix passes over the bucket axis; on CUDA one launch of the
   combine kernel a group runs every step (``g1_fused.bucket_combine``).
5. **Host window fold**: the W window sums come back and Horner with c
   doublings a window combines them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.bls12_377 import G1Point
from ..fields import dvec
from . import g1_fused, g1_limb

SCALAR_BITS = 256

def target_lanes(device: torch.device) -> int:
    """Grid-row width target: the lanes a group's segments are split into.
    On the card a lane is one thread of the accumulate kernel, so a narrow
    group fills the SMs only once it is split into enough lanes; on the CPU
    every lane costs the same, so rows stay narrow and padding lanes are
    avoided."""
    return 32768 if device.type == "cuda" else 1024


def default_accum(device: torch.device) -> str:
    """The Jacobian mixed add on every device: it needs no inversion, and
    on the card one kernel launch runs a group's whole accumulate.  The
    commitments are group elements, so the choice cannot change a proof's
    bytes."""
    return "madd"


def window_digits(scalars_std: np.ndarray, c: int) -> np.ndarray:
    """[N, 4] u64 standard-form scalars -> [W, N] int64 window digits."""
    std = np.ascontiguousarray(scalars_std, dtype="<u8")
    n = std.shape[0]
    w_count = (SCALAR_BITS + c - 1) // c
    mask = np.uint64((1 << c) - 1)
    out = np.zeros((w_count, n), dtype=np.int64)
    for w in range(w_count):
        l0, off = divmod(w * c, 64)
        d = std[:, l0] >> np.uint64(off)
        if off + c > 64 and l0 + 1 < 4:
            spill = off + c - 64
            high = std[:, l0 + 1] & np.uint64((1 << spill) - 1)
            d = d | (high << np.uint64(64 - off))
        out[w] = (d & mask).astype(np.int64)
    return out


def _meta_from_stats(per_window: list, lanes: int):
    """[(w, max_bucket_occupancy, max_digit)] -> [(window_ids, segs, b_g, depth)].

    Windows whose depth is within 2x of the group's smallest share a group.
    The top window's digits span only the scalar's leading bits, so it gets
    2^(bits used) buckets and, being deep and narrow, is split into S
    segments that accumulate in parallel lanes and fold at the end, until a
    group's row is ``lanes`` wide."""
    per_window = sorted(per_window, key=lambda t: t[1])
    groups: list[list[tuple]] = []
    for entry in per_window:
        if groups and entry[1] <= max(2 * max(groups[-1][0][1], 8), 64):
            groups[-1].append(entry)
        else:
            groups.append([entry])

    out = []
    for group in groups:
        raw_depth = max(max(e[1] for e in group), 1)
        g = len(group)
        max_digit = max(max(e[2], 1) for e in group)
        b_g = 1
        while b_g <= max_digit:
            b_g <<= 1
        b_g = max(b_g, 2)
        segs = 1
        while g * b_g * segs < lanes and segs * 2 <= raw_depth:
            segs <<= 1
        depth = (raw_depth + segs - 1) // segs
        out.append(([e[0] for e in group], segs, b_g, depth))
    return out


def build_schedule_meta(digits: np.ndarray, c: int, lanes: int):
    """Host grouping decisions from [W, N] digits (bincounts only)."""
    b = 1 << c
    per_window = []
    for w in range(digits.shape[0]):
        counts = np.bincount(digits[w], minlength=b)
        nz = counts[1:]
        live = np.nonzero(counts)[0]
        per_window.append(
            (w, int(nz.max()) if nz.size else 0, int(live.max()) if live.size else 1)
        )
    return _meta_from_stats(per_window, lanes)


def window_counts(digits: np.ndarray, b: int) -> np.ndarray:
    """[W, N] digits -> [W, b] bucket counts (a host bincount a window)."""
    out = np.zeros((digits.shape[0], b), dtype=np.int64)
    for w in range(digits.shape[0]):
        out[w] = np.bincount(digits[w], minlength=b)
    return out


def build_schedule(scalars_std: np.ndarray, c: int, offset: int = 0, lanes: int = 1024):
    """The host-grid oracle of the device schedule: [N, 4] standard-form
    scalars -> [(window_ids, segs, b_g, idx [D, g·S·B] int64, valid [D,
    g·S·B] bool)], one entry a group, by the grouping policy of
    :func:`build_schedule_meta` and the layout of
    :func:`device_grid_from_digits` (column w·S·B + s·B + d, row r lists the
    point of rank s·D + r among those whose window-w digit is d, in index
    order; digit 0 owns no entries), built with numpy only."""
    digits = window_digits(scalars_std, c)
    out = []
    for window_ids, segs, b_g, depth in build_schedule_meta(digits, c, lanes):
        g = len(window_ids)
        idx = np.zeros((g, depth, segs, b_g), dtype=np.int64)
        valid = np.zeros((g, depth, segs, b_g), dtype=bool)
        for slot, w in enumerate(window_ids):
            dw = digits[w]
            order = np.argsort(dw, kind="stable")
            sd = dw[order]
            starts = np.concatenate([[0], np.cumsum(np.bincount(sd, minlength=b_g))[:-1]])
            ranks = np.arange(dw.shape[0]) - starts[sd]
            keep = sd > 0
            seg, row = np.divmod(ranks[keep], depth)
            idx[slot, row, seg, sd[keep]] = order[keep] + offset
            valid[slot, row, seg, sd[keep]] = True
        # an invalid lane holds 0 here and a clamped index in the device grid;
        # the accumulate reads neither
        out.append((window_ids, segs, b_g,
                    idx.transpose(1, 0, 2, 3).reshape(depth, g * segs * b_g),
                    valid.transpose(1, 0, 2, 3).reshape(depth, g * segs * b_g)))
    return out


def device_grid_from_digits(digits_g: torch.Tensor, depth: int, segs: int, b: int,
                            offset: int):
    """[g, N] int64 digits -> (idx [D, g·S·B] int64, valid [D, g·S·B] bool):
    the scan grid, built by gathers from a per-window argsort."""
    g, n = digits_g.shape
    dev = digits_g.device
    order = torch.argsort(digits_g, dim=1, stable=True)  # points grouped by digit
    sorted_d = torch.gather(digits_g, 1, order)
    targets = torch.arange(b + 1, dtype=digits_g.dtype, device=dev).expand(g, b + 1).contiguous()
    starts = torch.searchsorted(sorted_d, targets)  # [g, b+1]
    counts = starts[:, 1:] - starts[:, :-1]  # [g, b]

    row = torch.arange(depth, device=dev).reshape(1, depth, 1, 1)
    seg = torch.arange(segs, device=dev).reshape(1, 1, segs, 1)
    dig = torch.arange(b, device=dev).reshape(1, 1, 1, b)
    k = seg * depth + row  # rank within the bucket                  [1, D, S, B]
    pos = starts[:, :-1].reshape(g, 1, 1, b) + k  # [g, D, S, B]
    valid = (k < counts.reshape(g, 1, 1, b)) & (dig > 0)
    pos = pos.clamp(0, n - 1)
    idx = torch.gather(order, 1, pos.reshape(g, -1)).reshape(g, depth, segs, b) + offset
    # [g, D, S, B] -> [D, g, S, B] -> [D, g·S·B] (one row per accumulate step)
    idx = idx.permute(1, 0, 2, 3).reshape(depth, g * segs * b)
    valid = valid.expand(g, depth, segs, b).permute(1, 0, 2, 3).reshape(depth, g * segs * b)
    return idx, valid


def accumulate_windows(points_xy: torch.Tensor, idx: torch.Tensor, valid: torch.Tensor,
                       w_count: int, segs: int, b: int, accum: str | None = None):
    """(points_xy [2, 24, n] affine planes, idx/valid [D, W·S·B]) -> ([24, W],)*3
    Jacobian window sums Σ_d d·S_d.

    ``accum``: ``"madd"`` does the 11-mul Jacobian mixed add, all D rows in
    one accumulate-kernel launch on CUDA; ``"affine"`` keeps the accumulator
    affine and does batch-affine adds (~4 muls plus a shared batched
    inversion a row, a Python loop over the rows).  Either way the bucket
    combine follows, one combine-kernel launch on CUDA."""
    dev = points_xy.device
    if accum is None:
        accum = default_accum(dev)
    lanes = w_count * segs * b
    # row-major copy: one gather fetches a point's 48 limbs together
    rows = points_xy.reshape(2 * 24, -1).t().contiguous()  # [n, 48]

    if accum == "madd":
        acc = g1_fused.madd_accumulate(None, rows, idx, valid)
    elif accum == "affine":
        zero = torch.zeros((24, lanes), dtype=torch.int32, device=dev)
        acc2 = (zero, zero)  # the affine identity
        for d in range(idx.shape[0]):
            pts = rows.index_select(0, idx[d]).t().contiguous()  # [48, lanes]
            acc2 = g1_limb.affine_madd(acc2, (pts[:24], pts[24:]), valid[d])
        acc = g1_limb.affine_to_jacobian(acc2)
    else:
        raise ValueError(f"unknown accumulate mode {accum!r}")

    return g1_fused.bucket_combine(acc, w_count, segs, b)


def _auto_window_bits(n: int) -> int:
    """Window bits: larger windows win once N amortises the bucket combine
    (2c·W·2^c adds against N·W in the scan)."""
    if n >= 1 << 19:
        return 13
    if n >= 1 << 12:
        return 8
    return max(2, n.bit_length() // 2)


def _digits_from_std16(std16: torch.Tensor, c: int) -> torch.Tensor:
    """[16, N] standard-form 16-bit limbs -> [W, N] int64 window digits."""
    s = std16.to(torch.int64)
    mask = (1 << c) - 1
    rows = []
    for w in range((SCALAR_BITS + c - 1) // c):
        l0, off = divmod(w * c, 16)
        d = s[l0] >> off
        if off + c > 16 and l0 + 1 < 16:  # c <= 16: two limbs at most
            d = d | (s[l0 + 1] << (16 - off))
        rows.append(d & mask)
    return torch.stack(rows)


def mont_digits(mont: torch.Tensor, c: int):
    """[16, N] Montgomery limbs -> (digits [W, N] int64, stats [W, 2] int64:
    largest occupancy of a nonzero bucket, largest live digit)."""
    digits = _digits_from_std16(dvec.to_standard(mont), c)
    b = 1 << c
    sd, _ = torch.sort(digits, dim=1)
    targets = torch.arange(b + 1, dtype=sd.dtype, device=sd.device).expand(sd.shape[0], b + 1)
    starts = torch.searchsorted(sd, targets.contiguous())
    counts = starts[:, 1:] - starts[:, :-1]  # [W, b]
    occ = counts[:, 1:].max(dim=1).values
    digit_ids = torch.arange(b, dtype=counts.dtype, device=counts.device)
    live = torch.where(counts > 0, digit_ids, torch.zeros_like(counts)).max(dim=1).values
    return digits, torch.stack([occ, live], dim=1)


def _msm_from_digits(points_xy, digits, metas, c: int, offset: int, accum) -> G1Point:
    w_count = (SCALAR_BITS + c - 1) // c
    window_points = [G1Point.identity()] * w_count
    for window_ids, segs, b_g, depth in metas:
        ids = torch.tensor(window_ids, dtype=torch.int64, device=digits.device)
        idx, valid = device_grid_from_digits(digits.index_select(0, ids), depth, segs, b_g, offset)
        wins = accumulate_windows(points_xy, idx, valid, len(window_ids), segs, b_g, accum)
        for w, pt in zip(window_ids, g1_limb.points_from_limb_major(wins)):
            window_points[w] = pt
    total = G1Point.identity()
    for wp in reversed(window_points):
        for _ in range(c):
            total = total.double()
        total = total.add(wp)
    return total


def _check_range(points_xy: torch.Tensor, n: int, offset: int) -> None:
    if points_xy.dim() != 3 or points_xy.shape[:2] != (2, 24):
        raise ValueError(f"expected [2, 24, N] affine point planes, got {tuple(points_xy.shape)}")
    if offset < 0 or offset + n > points_xy.shape[2]:
        raise ValueError(
            f"points {offset}..{offset + n} exceed the table of {points_xy.shape[2]}"
        )


def msm_device_mont(points_xy: torch.Tensor, coeffs: torch.Tensor, offset: int = 0,
                    c: int | None = None, accum: str | None = None) -> G1Point:
    """MSM of Montgomery-form coefficients ``[16, N]`` (on the points' device)
    against points ``offset..offset+N`` of the [2, 24, M] affine planes."""
    n = int(coeffs.shape[1])
    if n == 0:
        return G1Point.identity()
    _check_range(points_xy, n, offset)
    if c is None:
        c = _auto_window_bits(n)
    digits, stats = mont_digits(coeffs, c)
    stats_np = stats.cpu().numpy()  # the one data-dependent fetch: [W, 2]
    per_window = [
        (w, int(stats_np[w, 0]), max(int(stats_np[w, 1]), 1)) for w in range(stats_np.shape[0])
    ]
    metas = _meta_from_stats(per_window, target_lanes(coeffs.device))
    return _msm_from_digits(points_xy, digits, metas, c, offset, accum)


def msm_device(points_xy: torch.Tensor, scalars_std: np.ndarray, c: int | None = None,
               offset: int = 0, accum: str | None = None) -> G1Point:
    """MSM of ``scalars_std`` ([N, 4] u64 standard form) against points
    ``offset..offset+N`` of the [2, 24, M] affine planes (digits cut on the
    host, grids built on the device)."""
    n = scalars_std.shape[0]
    if n == 0:
        return G1Point.identity()
    _check_range(points_xy, n, offset)
    if c is None:
        c = _auto_window_bits(n)
    digits = window_digits(scalars_std, c)
    metas = build_schedule_meta(digits, c, target_lanes(points_xy.device))
    digits_t = torch.from_numpy(digits).to(points_xy.device)
    return _msm_from_digits(points_xy, digits_t, metas, c, offset, accum)

"""Device Pippenger MSM over BLS12-377 G1 (the KZG commit kernel path).

Port of the default device route of ``simpleworks_tpu/ops/msm_pippenger.py``
(``msm_device_mont``), with a schedule whose memory is bounded:

1. **Digits on the device** (span ``msm.digits``): Montgomery coefficients
   ``[16, N]`` leave Montgomery form by one field multiply with the literal
   1, and are cut into W = ⌈256/c⌉ windows of c bits, int32 ``[W, N]``.
   A count of each window's buckets gives the only data-dependent facts the
   host needs: each window's largest bucket occupancy and largest live digit
   (one [W, 2] fetch).
2. **Passes**: windows are grouped by occupancy depth; a group whose working
   set exceeds the device-memory budget (:func:`memory_budget`, which asks
   the card only when the widest group may not fit) is cut into slices of
   its windows, and each group or slice is one pass.
3. **Grid** (span ``msm.grid``): a pass's windows are sorted by digit (one
   stable sort, the pass's windows only) and become a ``[D, g·S·B]`` gather
   grid (column w·S·B + s·B + d lists the points whose window-w digit is d;
   digit 0 has weight 0 and owns no entries), its positions in int32.
4. **Accumulate** (span ``msm.accumulate``): the D grid rows gather affine
   points (X, Y only: the SRS is normalised to Z = 1 and kept row-major, the
   layout the accumulate reads) into per-lane bucket sums.  The default is
   the Jacobian mixed add (``"madd"``): on CUDA one launch of the accumulate
   kernel a pass runs all D rows with the sums in registers
   (``g1_fused.madd_accumulate``).  ``"affine"`` is a Python loop over the
   rows, each one complete batch-affine add (``g1_limb.affine_madd``, ~25
   field-kernel launches and one Fermat pow a row), the reference's TPU
   default, kept as an option and as the oracle.
5. **Bucket combine** (span ``msm.combine``): segment fold, then Σ_d d·S_d
   per window by two inclusive suffix passes over the bucket axis; on CUDA
   one launch of the combine kernel a pass (``g1_fused.bucket_combine``).
6. **Host window fold** (span ``msm.fold``): the W window sums come back and
   Horner with c doublings a window combines them.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.bls12_377 import G1Point
from ..fields import dvec
from ..utils.observability import PROVER_TIMER
from . import g1_fused, g1_limb

SCALAR_BITS = 256
#: window bits from 2^24 points: on one H100 the fastest of c = 13..17 at
#: 2^24 and 2^25 points and of c = 13..20 at 2^26, and slower than c = 13
#: at 2^21..2^23 (PERF.md, the window sweeps of ``kzg.commit-2p26``)
LARGE_WINDOW_BITS = 16
#: the fewest points that take ``LARGE_WINDOW_BITS``
LARGE_WINDOW_POINTS = 1 << 24
#: the passes' working set on the CPU, bytes
CPU_BUDGET = 4 << 30
#: a pass's bytes a point of each of its windows: the window's int32 digits,
#: the stable sort's int32 keys and int64 order out, and its radix scratch
SORT_BYTES = 28
#: a pass's bytes a grid cell: its int32 position, its valid flag and the
#: int64 table row the accumulate reads
CELL_BYTES = 13
#: a pass's bytes a lane: the accumulate's Jacobian sums (3 × 24 int32) and
#: the combine's two scratch planes
LANE_BYTES = 576


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


def memory_budget(device: torch.device, need: int) -> int:
    """Bytes one pass may hold, for an MSM whose one-pass plan needs ``need``
    bytes in its widest pass.  On the CPU, ``CPU_BUDGET``.  On the card,
    ``need`` itself while it fits in what the card's total memory leaves
    beside the allocated tensors less a quarter of the card (the allocator's
    counters: no device query, so the 2^20 commit and a prove's MSMs, a few
    GB each, never ask); past that, what is free beside the tensors held
    (the free memory ``cudaMemGetInfo`` gives and the allocator's cached,
    unused blocks) less an eighth of the card for the allocator's
    fragments."""
    if device.type != "cuda":
        return CPU_BUDGET
    total = torch.cuda.get_device_properties(device).total_memory
    allocated = torch.cuda.memory_allocated(device)
    if need <= total - allocated - total // 4:
        return need
    free, total = torch.cuda.mem_get_info(device)
    cached = torch.cuda.memory_reserved(device) - allocated
    return max(0, free + cached - total // 8)


def pass_bytes(n: int, windows: int, segs: int, b: int, depth: int) -> int:
    """The working set of a pass of ``windows`` windows over ``n`` points
    with S = ``segs``, B = ``b`` and grid depth D: its sort, its grid and its
    lanes (the digits of every window are held apart, for the whole MSM)."""
    lanes = windows * segs * b
    return windows * n * SORT_BYTES + depth * lanes * CELL_BYTES + lanes * LANE_BYTES


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


def plan_passes(per_window: list, n: int, lanes: int, budget: int):
    """The passes of an MSM over ``n`` points: the groups of
    :func:`_meta_from_stats`, each cut into the fewest even slices of its
    windows whose :func:`pass_bytes` fit ``budget``.  A group that fits is
    one pass, as it is; a window that alone does not fit raises."""
    stats = {entry[0]: entry for entry in per_window}
    out = []
    for meta in _meta_from_stats(per_window, lanes):
        window_ids = meta[0]
        for parts in range(1, len(window_ids) + 1):
            if parts == 1:
                metas = [meta]
            else:
                size = -(-len(window_ids) // parts)
                metas = [m for k in range(0, len(window_ids), size)
                         for m in _meta_from_stats([stats[w] for w in window_ids[k:k + size]],
                                                   lanes)]
            if all(pass_bytes(n, len(m[0]), *m[1:]) <= budget for m in metas):
                out.extend(metas)
                break
        else:
            need = min(pass_bytes(n, len(m[0]), *m[1:]) for m in metas)
            raise MemoryError(f"a pass of one window over {n} points needs {need} bytes; "
                              f"the budget is {budget}")
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


def bucket_counts(digits: torch.Tensor, b: int) -> torch.Tensor:
    """[g, N] digits (any integer dtype, each below ``b``) -> [g, b] int32
    bucket counts: one scatter-add of ones a window, on the digits' device."""
    counts = torch.zeros((digits.shape[0], b), dtype=torch.int32, device=digits.device)
    ones = torch.ones(1, dtype=torch.int32, device=digits.device).expand(digits.shape[1])
    for w in range(digits.shape[0]):
        counts[w].index_add_(0, digits[w], ones)
    return counts


def window_order(digits_g: torch.Tensor) -> torch.Tensor:
    """[g, N] digits -> [g, N] int64: each window's points in digit order, in
    index order within a digit (one stable sort of the pass's windows)."""
    return torch.sort(digits_g, dim=1, stable=True).indices


def grid_from_order(order: torch.Tensor, counts: torch.Tensor, depth: int, segs: int, b: int,
                    offset: int):
    """(order [g, N] of :func:`window_order`, counts [g, b]) -> (idx [D, g·S·B]
    int64, valid [D, g·S·B] bool), built in its final layout: lane (w, s, d)
    of row r reads the point of rank s·D + r among those of digit d in window
    w, its position in ``order`` computed in int32 while g·N < 2^31."""
    g, n = order.shape
    dev = order.device
    itype = torch.int32 if g * n < 1 << 31 else torch.int64
    counts = counts.to(itype)
    starts = (torch.cumsum(counts, dim=1, dtype=itype) - counts).reshape(1, g, 1, b)
    row = torch.arange(depth, dtype=itype, device=dev).reshape(depth, 1, 1, 1)
    seg = torch.arange(segs, dtype=itype, device=dev).reshape(1, 1, segs, 1)
    k = seg * depth + row  # rank within the bucket                     [D, 1, S, 1]
    valid = (k < counts.reshape(1, g, 1, b)) & (torch.arange(b, device=dev) > 0)
    pos = (starts + k).clamp_(max=n - 1)  # [D, g, S, B]
    pos += (torch.arange(g, dtype=itype, device=dev) * n).reshape(1, g, 1, 1)
    idx = order.reshape(-1).index_select(0, pos.reshape(-1)).reshape(depth, g * segs * b)
    if offset:
        idx += offset
    return idx, valid.reshape(depth, g * segs * b)


def device_grid_from_digits(digits_g: torch.Tensor, depth: int, segs: int, b: int,
                            offset: int):
    """[g, N] digits (any integer dtype) -> (idx [D, g·S·B] int64, valid
    [D, g·S·B] bool): the scan grid, from a stable sort of the digits and
    their bucket counts."""
    return grid_from_order(window_order(digits_g), bucket_counts(digits_g, b), depth, segs, b,
                           offset)


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
    rows = g1_limb.table_rows(points_xy)  # [n, 48]: a copy unless the table is row-major

    with PROVER_TIMER.region("msm.accumulate"):
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

    with PROVER_TIMER.region("msm.combine"):
        return g1_fused.bucket_combine(acc, w_count, segs, b)


def _auto_window_bits(n: int) -> int:
    """Window bits: larger windows win once N amortises the bucket combine
    (2c·W·2^c adds against N·W in the scan)."""
    if n >= LARGE_WINDOW_POINTS:
        return LARGE_WINDOW_BITS
    if n >= 1 << 19:
        return 13
    if n >= 1 << 12:
        return 8
    return max(2, n.bit_length() // 2)


def _digits_from_std16(std16: torch.Tensor, c: int) -> torch.Tensor:
    """[16, N] standard-form 16-bit limbs -> [W, N] int32 window digits
    (c <= 30: a window's bits, shifted into place, stay below 2^31)."""
    w_count = (SCALAR_BITS + c - 1) // c
    out = torch.empty((w_count, std16.shape[1]), dtype=torch.int32, device=std16.device)
    for w in range(w_count):
        lo, hi = w * c, min(w * c + c, SCALAR_BITS)
        row = out[w]
        torch.bitwise_right_shift(std16[lo // 16], lo % 16, out=row)
        if hi < (lo // 16 + 1) * 16:  # the window ends inside its first limb
            row &= (1 << (hi - lo)) - 1
        for limb in range(lo // 16 + 1, (hi + 15) // 16):
            bits = min(16, hi - 16 * limb)  # of this limb inside the window
            part = std16[limb] if bits == 16 else std16[limb] & ((1 << bits) - 1)
            row |= part << (16 * limb - lo)
    return out


def _stats(counts: torch.Tensor) -> torch.Tensor:
    """[W, b] bucket counts -> [W, 2]: the largest occupancy of a nonzero
    bucket, the largest live digit."""
    occ = counts[:, 1:].amax(dim=1)
    digit_ids = torch.arange(counts.shape[1], dtype=counts.dtype, device=counts.device)
    live = torch.where(counts > 0, digit_ids, torch.zeros_like(counts)).amax(dim=1)
    return torch.stack([occ, live], dim=1)


def _digits_and_counts(mont: torch.Tensor, c: int):
    std = dvec.to_standard(mont)
    digits = _digits_from_std16(std, c)
    del std
    return digits, bucket_counts(digits, 1 << c)


def mont_digits(mont: torch.Tensor, c: int):
    """[16, N] Montgomery limbs -> (digits [W, N] int32, stats [W, 2]: largest
    occupancy of a nonzero bucket, largest live digit)."""
    digits, counts = _digits_and_counts(mont, c)
    return digits, _stats(counts)


def _msm_passes(points_xy, digits, counts, metas, c: int, offset: int, accum) -> G1Point:
    """Every pass's grid, accumulate and combine, then the host's fold of
    the window sums (fetched once, after the last pass)."""
    sums = []
    for window_ids, segs, b_g, depth in metas:
        with PROVER_TIMER.region("msm.grid"):
            ids = torch.tensor(window_ids, dtype=torch.int64, device=digits.device)
            order = window_order(digits.index_select(0, ids))
            idx, valid = grid_from_order(order, counts.index_select(0, ids)[:, :b_g].contiguous(),
                                         depth, segs, b_g, offset)
            del order
        sums.append((window_ids, accumulate_windows(points_xy, idx, valid, len(window_ids),
                                                    segs, b_g, accum)))
        del idx, valid
    with PROVER_TIMER.region("msm.fold"):
        window_points = [G1Point.identity()] * digits.shape[0]
        ids = [w for window_ids, _ in sums for w in window_ids]
        planes = tuple(torch.cat([wins[k] for _, wins in sums], dim=1) for k in range(3))
        for w, pt in zip(ids, g1_limb.points_from_limb_major(planes)):
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
    against points ``offset..offset+N`` of the [2, 24, M] affine planes, in
    passes whose working set fits :func:`memory_budget`."""
    n = int(coeffs.shape[1])
    if n == 0:
        return G1Point.identity()
    _check_range(points_xy, n, offset)
    if c is None:
        c = _auto_window_bits(n)
    with PROVER_TIMER.region("msm.digits"):
        digits, counts = _digits_and_counts(coeffs, c)
        stats_np = _stats(counts).cpu().numpy()  # the one data-dependent fetch: [W, 2]
    per_window = [
        (w, int(stats_np[w, 0]), max(int(stats_np[w, 1]), 1)) for w in range(stats_np.shape[0])
    ]
    lanes = target_lanes(coeffs.device)
    need = max(pass_bytes(n, len(m[0]), *m[1:]) for m in _meta_from_stats(per_window, lanes))
    metas = plan_passes(per_window, n, lanes, memory_budget(coeffs.device, need))
    return _msm_passes(points_xy, digits, counts, metas, c, offset, accum)


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
    digits_t = torch.from_numpy(digits.astype(np.int32)).to(points_xy.device)
    return _msm_passes(points_xy, digits_t, bucket_counts(digits_t, 1 << c), metas, c, offset,
                       accum)

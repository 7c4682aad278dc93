"""The butterfly NTT over BLS12-377 Fr: the pass kernel that runs every
transform, the two kernels of the stage route it replaced, and the plain
PyTorch version beside each.

The transform of :mod:`..poly.ntt_device` (the port of
``simpleworks_tpu/poly/ntt_device.py``, the XLA butterfly NTT that the JAX
package runs on every backend that is not a TPU) runs over a batch of B
contiguous transforms of n = 2^log_n points ([16, B, n] int32 Montgomery
limbs), natural order in and out, the inverse scaled by 1/n:

* :func:`ntt_transform` (kernel ``ntt_pass_kernel``): a four-step split
  of n into passes of tiles of at most 2^:data:`MAX_TILE_LOG` points
  (:func:`pass_tiles`: one pass up to 2^11, two up to 2^22).  Pass p, with
  D the points of the earlier passes and S = n/T, takes column lo of its
  input (the T points t·S + lo), runs a size-T DFT on it (decimation in
  frequency, so its outputs come out bit-reversed), and writes output k to
  q·T·D + k·D + r (lo = q·D + r), times ω^(D·q·k) when a pass follows and
  times 1/n on the inverse's last pass.  The tables (:class:`PassTables`):
  one table of the stage twiddles ω_2h^k of every stage (stage h from entry
  h − 1, 2^11 − 1 entries at most), and ω^E = hi[E >> log_lo]·lo[E & mask]
  for the four-step twiddle.  On the card each pass is one launch of the
  kernel over all B·S columns, a tile of C columns a block in shared
  memory, the bit reversal folded into the store, the data between passes
  packed (8 32-bit words an element) (``csrc/ntt_kernels.cu``);
  :func:`ntt_passes_plain` is the same passes, stages and twiddles over the
  plain field ops, its largest tile a parameter (the tests force small
  tiles, so that a few points run several passes).
* The stage route (no path runs it; ``chip_smoke.check_ntt`` holds the
  pass kernel against it and times it as the baseline):
  :func:`ntt_bitrev`, the bit-reversal permutation of each transform, out
  of place (the reference's gather by ``_bit_reverse_indices``,
  ``ntt_device.py:35-41, :81``), then :func:`ntt_butterfly` once a stage
  s = 0 .. log_n − 1, in place: with h = 2^s, each butterfly pairs lo
  (offset k of a block of 2h) with hi = lo + h, t = hi·w^k, lo ← lo + t,
  hi ← lo − t, where w^k is entry k·n/2h of one table of the n/2
  Montgomery powers of ω (the reference's stage, ``ntt_device.py:82-88``);
  ``scale`` multiplies both outputs by a constant (the inverse's 1/n on its
  last stage, ``:89-90``).  :func:`stage_route` runs the whole transform so.

A CUDA tensor launches the kernels of ``csrc/ntt_kernels.cu`` or the wrapper
raises; a CPU tensor takes the plain version beside each, over
:mod:`.mont_mul`'s plain multiply, add and subtract.  There is no fallback
between the two.  ``LAUNCHES["ntt_pass"]`` (one a pass),
``["ntt_bitrev"]`` and ``["ntt_butterfly"]`` count the kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from typing import NamedTuple

from ..fields.device import FR, split_words
from ._build import count_launch
from .mont_mul import _on_cuda, _raise_on, mod_add_sub_plain, mont_mul_plain

L = FR.n_limbs
#: the largest transform the kernels index (2^30 points)
MAX_LOG = 30


def _log2(n: int) -> int:
    if n < 1 or n & (n - 1) or n > 1 << MAX_LOG:
        raise ValueError(f"NTT size must be a power of two of at most 2^{MAX_LOG}, got {n}")
    return n.bit_length() - 1


def _check_batch(x: torch.Tensor) -> int:
    """log2(n) of a [16, B, n] int32 limb tensor; raises on anything else."""
    if x.dtype != torch.int32 or x.dim() != 3 or x.shape[0] != L:
        raise ValueError(f"expected a [16, B, n] int32 limb tensor, got {tuple(x.shape)} {x.dtype}")
    return _log2(x.shape[2])


@lru_cache(maxsize=8)
def bit_reverse_indices(n: int, device: torch.device) -> torch.Tensor:
    """[n] int64: index j's log2(n)-bit reversal (the reference's
    ``_bit_reverse_indices``)."""
    bits = _log2(n)
    idx = torch.arange(n, dtype=torch.int64)
    rev = torch.zeros(n, dtype=torch.int64)
    for b in range(bits):
        rev |= ((idx >> b) & 1) << (bits - 1 - b)
    return rev.to(device)


# ------------------------------------------------------------ bit reversal --


def ntt_bitrev_plain(x: torch.Tensor) -> torch.Tensor:
    """out[:, b, j] = x[:, b, rev(j)] for [16, B, n] (a new tensor)."""
    return x.index_select(2, bit_reverse_indices(x.shape[2], x.device))


def ntt_bitrev(x: torch.Tensor) -> torch.Tensor:
    """The bit-reversal permutation of each of the B transforms of
    [16, B, n] x, into a new dense tensor."""
    log_n = _check_batch(x)
    if not _on_cuda(x):
        return ntt_bitrev_plain(x)
    from ._build import library

    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = library("ntt_kernels").swt_ntt_bitrev(x.data_ptr(), out.data_ptr(), x.shape[1],
                                                   log_n, stream)
    _raise_on(rc, "ntt_bitrev")
    count_launch("ntt_bitrev")
    return out


# --------------------------------------------------------------- butterfly --


def _check_stage(x: torch.Tensor, stage: int, twiddles: torch.Tensor) -> int:
    log_n = _check_batch(x)
    if not 0 <= stage < log_n:
        raise ValueError(f"stage {stage} outside 0..{log_n - 1} of a {x.shape[2]}-point transform")
    half = x.shape[2] // 2
    if twiddles.dtype != torch.int32 or tuple(twiddles.shape) != (L, half):
        raise ValueError(f"expected a [16, {half}] int32 twiddle table, got "
                         f"{tuple(twiddles.shape)} {twiddles.dtype}")
    if twiddles.device != x.device:
        raise ValueError(f"twiddles on {twiddles.device}, data on {x.device}")
    if not x.is_contiguous():
        raise ValueError("a butterfly stage runs in place on a dense [16, B, n] tensor")
    return log_n


@lru_cache(maxsize=64)
def _scale_words(scale: int):
    """The 8 32-bit words of ``scale``'s Montgomery form (the kernel's)."""
    return (ctypes.c_uint32 * FR.n_words)(*split_words(scale % FR.p * FR.r % FR.p, FR.n_words, 32))


def ntt_butterfly_plain(x: torch.Tensor, stage: int, twiddles: torch.Tensor,
                        scale: int | None = None) -> torch.Tensor:
    """Stage ``stage`` of every transform of [16, B, n] x, in place (x is
    returned): the kernel's arithmetic over the plain field ops."""
    _, B, n = x.shape
    h = 1 << stage
    y = x.view(L, B, n // (2 * h), 2, h)
    lo, hi = y[:, :, :, 0, :], y[:, :, :, 1, :]
    w = twiddles[:, :: n // (2 * h)]  # [16, h]: w^k = ω^(k·n/2h)
    a = lo.reshape(L, -1)
    t = mont_mul_plain(hi.reshape(L, -1), w[:, None, None, :].expand(lo.shape).reshape(L, -1), FR)
    out_lo, out_hi = mod_add_sub_plain(a, t, FR)
    if scale is not None:
        s = FR.col(split_words(scale % FR.p * FR.r % FR.p, L, 16), x.device).expand_as(a)
        out_lo, out_hi = mont_mul_plain(out_lo, s, FR), mont_mul_plain(out_hi, s, FR)
    lo.copy_(out_lo.view(lo.shape))
    hi.copy_(out_hi.view(hi.shape))
    return x


def ntt_butterfly(x: torch.Tensor, stage: int, twiddles: torch.Tensor,
                  scale: int | None = None) -> torch.Tensor:
    """Radix-2 stage ``stage`` (half-block 2^stage) of each of the B
    transforms of the dense [16, B, n] x, in place, with ``twiddles`` the
    [16, n/2] Montgomery table of ω^k; both outputs times the standard-form
    ``scale`` when it is given.  Returns x."""
    log_n = _check_stage(x, stage, twiddles)
    if not _on_cuda(x):
        return ntt_butterfly_plain(x, stage, twiddles, scale)
    from ._build import library

    if x.numel() == 0:
        return x
    twiddles = twiddles.contiguous()
    scale_ptr = None if scale is None else ctypes.addressof(_scale_words(scale))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = library("ntt_kernels").swt_ntt_butterfly(
            x.data_ptr(), x.shape[1], log_n, stage, twiddles.data_ptr(),
            FR.p_words_ptr, FR.n0_32, FR.one_words_ptr, scale_ptr, stream)
    _raise_on(rc, "ntt_butterfly")
    count_launch("ntt_butterfly")
    return x


def stage_route(x: torch.Tensor, twiddles: torch.Tensor, scale: int | None = None) -> torch.Tensor:
    """The whole transform of each of the B transforms of [16, B, n] x by the
    stage route (a new tensor): :func:`ntt_bitrev`, then every
    :func:`ntt_butterfly` stage over the [16, n/2] table, ``scale`` on the
    last."""
    log_n = _check_batch(x)
    y = ntt_bitrev(x)
    for stage in range(log_n):
        ntt_butterfly(y, stage, twiddles, scale if stage == log_n - 1 else None)
    return y


# ------------------------------------------------------------- pass kernel --

#: the largest tile a pass transforms in one block: 2^11 points (one pass up
#: to 2^11, two up to 2^22, three up to 2^30)
MAX_TILE_LOG = 11
#: columns a block of the pass kernel takes at most: 2^3, so that a warp's
#: lanes of one point read whole 32-byte sectors of each limb row
MAX_COLUMNS_LOG = 3
#: threads a block of the pass kernel at most (its __launch_bounds__)
PASS_THREADS = 512
#: the H100's shared memory a block may opt in to (bytes)
SMEM_LIMIT = 232_448
#: a pass takes fewer columns a block rather than leave the H100's 132 SMs
#: with fewer blocks than this
MIN_BLOCKS = 128
#: blocks of 2^QUAD_POINTS_LOG points or more run their stages in pairs
QUAD_POINTS_LOG = 10


class PassTables(NamedTuple):
    """The tables of one direction (ω, or ω⁻¹ for the inverse) of a
    transform of n points, as [16, N] int32 Montgomery limbs (the plain
    version's):

    * ``stage``: the in-tile stage twiddles ω_2h^k (ω_2h = ω^(n/2h)) of
      stages h = 1, 2, 4, .. at entries h − 1 + k, 2^s − 1 entries for tiles
      of up to 2^s points;
    * ``hi``, ``lo``: ω^(i·2^log_lo) and ω^i, so that the four-step twiddle
      ω^E = hi[E >> log_lo]·lo[E mod 2^log_lo];

    and ``packed``: the three as [N, 8] int32 words (word w = limb 2w |
    limb 2w + 1 << 16, one 32-byte row an entry), the kernel's; None on the
    CPU."""

    stage: torch.Tensor
    hi: torch.Tensor
    lo: torch.Tensor
    log_lo: int
    packed: tuple | None


def pack_words(limbs: torch.Tensor) -> torch.Tensor:
    """[16, N] int32 16-bit limbs -> dense [N, 8] int32 32-bit words."""
    words = limbs[0::2].to(torch.int64) | (limbs[1::2].to(torch.int64) << 16)
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).t().contiguous()


def pass_tiles(log_n: int, max_tile_log: int = MAX_TILE_LOG) -> tuple[int, ...]:
    """The tile logs of the passes of a 2^log_n-point transform, tiles of at
    most 2^max_tile_log points: one pass where a tile holds the transform;
    two up to twice the largest tile, the first 2^(log_n // 2 + 1) points
    or the largest tile (2^20: 2^11 then 2^9, so that the second pass's
    tiles are small enough for eight columns a block; the split that ran
    fastest at every size from 2^14 to 2^20 in the H100's plan sweep); more
    passes split evenly, the larger first."""
    if not 1 <= max_tile_log <= MAX_TILE_LOG:
        raise ValueError(f"a tile holds 2^1 to 2^{MAX_TILE_LOG} points, not 2^{max_tile_log}")
    if log_n <= max_tile_log:
        return (log_n,)
    if log_n <= 2 * max_tile_log:
        first = min(max_tile_log, log_n // 2 + 1)
        return (first, log_n - first)
    passes = -(-log_n // max_tile_log)
    base, extra = divmod(log_n, passes)
    return tuple(base + (p < extra) for p in range(passes))


def tile_smem_bytes(log_t: int, log_c: int) -> int:
    """Shared memory of a block of the pass kernel: the stage twiddles (T
    words a word plane) and C columns of T points (padded by 32/C words)."""
    T = 1 << log_t
    return 32 * (T + ((T + (32 >> log_c if T >= 32 else 0)) << log_c))


def pass_plan(log_n: int, batch: int) -> tuple[tuple[int, int, int, int], ...]:
    """(log_t, log_c, threads, quad) of each pass of :func:`pass_tiles` for a
    transform of ``batch`` times 2^log_n points on the card: C = 2^log_c
    columns a block, the most (up to 2^MAX_COLUMNS_LOG) whose tile fits in
    shared memory while the pass keeps about a block an SM; one thread a
    butterfly, at most PASS_THREADS; stages in pairs (quad) where a block
    holds 2^QUAD_POINTS_LOG points or more, there the barriers and tile
    traffic they halve cost more than the registers they take (the H100's
    plan sweep)."""
    plan = []
    for log_t in pass_tiles(log_n):
        columns = batch << (log_n - log_t)
        log_c = MAX_COLUMNS_LOG
        while log_c and (tile_smem_bytes(log_t, log_c) > SMEM_LIMIT or columns >> log_c < MIN_BLOCKS):
            log_c -= 1
        butterflies = 1 << (log_t + log_c - 1) if log_t + log_c else 1
        plan.append((log_t, log_c, min(PASS_THREADS, -(-butterflies // 32) * 32),
                     int(log_t + log_c >= QUAD_POINTS_LOG)))
    return tuple(plan)


def _dif_plain(cols: torch.Tensor, stage: torch.Tensor, log_t: int) -> torch.Tensor:
    """The size-2^log_t DFT of each row of [16, M, T] by decimation in
    frequency: lo ← lo + hi, hi ← (lo − hi)·ω_2h^k for h = T/2 .. 1; the
    outputs in bit-reversed order."""
    _, M, T = cols.shape
    for s in reversed(range(log_t)):
        h = 1 << s
        v = cols.view(L, M, T // (2 * h), 2, h)
        a, d = mod_add_sub_plain(v[:, :, :, 0].reshape(L, -1), v[:, :, :, 1].reshape(L, -1), FR)
        if s:  # ω_2^0 = 1: the first stage multiplies by nothing
            w = stage[:, h - 1 : 2 * h - 1][:, None, :].expand(L, M * T // (2 * h), h)
            d = mont_mul_plain(d, w.reshape(L, -1), FR)
        cols = torch.stack([a.view(L, M, T // (2 * h), h), d.view(L, M, T // (2 * h), h)],
                           dim=3).view(L, M, T)
    return cols


def _four_step_twiddles(tables: PassTables, log_s: int, log_t: int, log_d: int,
                        device) -> torch.Tensor:
    """[16, S·T]: ω^(D·q·k) for column lo = q·D + r (major) and output k."""
    lo = torch.arange(1 << log_s, dtype=torch.int64, device=device)
    e = (((lo >> log_d) << log_d)[:, None]
         * torch.arange(1 << log_t, dtype=torch.int64, device=device)[None, :]).reshape(-1)
    mask = (1 << tables.log_lo) - 1
    return mont_mul_plain(tables.hi[:, e >> tables.log_lo], tables.lo[:, e & mask], FR)


def ntt_passes_plain(x: torch.Tensor, tables: PassTables, scale: int | None = None,
                     max_tile_log: int = MAX_TILE_LOG) -> torch.Tensor:
    """The kernel's passes over the plain field ops: each of the B transforms
    of [16, B, n] x (natural order in and out; every output times the
    standard-form ``scale`` when it is given), tiles of at most
    2^max_tile_log points -> a new [16, B, n] tensor."""
    log_n = _check_batch(x)
    _, B, n = x.shape
    tiles = pass_tiles(log_n, max_tile_log)
    y, log_d = x, 0
    for p, log_t in enumerate(tiles):
        log_s = log_n - log_t
        T, S, D = 1 << log_t, 1 << log_s, 1 << log_d
        cols = y.reshape(L, B, T, S).transpose(2, 3).reshape(L, B * S, T)  # column lo, point t
        cols = _dif_plain(cols, tables.stage, log_t)
        flat = cols.index_select(2, bit_reverse_indices(T, x.device)).reshape(L, -1)  # output k
        if p < len(tiles) - 1:
            tw = _four_step_twiddles(tables, log_s, log_t, log_d, x.device)
            flat = mont_mul_plain(flat, tw.view(L, 1, -1).expand(L, B, S * T).reshape(L, -1), FR)
        elif scale is not None:
            s = FR.col(split_words(scale % FR.p * FR.r % FR.p, L, 16), x.device).expand_as(flat)
            flat = mont_mul_plain(flat, s, FR)
        # output k of column lo = q·D + r goes to q·T·D + k·D + r
        y = flat.reshape(L, B, S // D, D, T).transpose(3, 4).reshape(L, B, n)
        log_d += log_t
    return y.contiguous()


def _check_tables(x: torch.Tensor, tables: PassTables, log_n: int) -> None:
    if tables.packed is None:
        raise ValueError("the pass kernel needs the tables packed on the card")
    stage, hi, lo = tables.packed
    want = {"stage": (1 << min(max(log_n, 1), MAX_TILE_LOG)) - 1,
            "hi": 1 << (log_n - tables.log_lo), "lo": 1 << tables.log_lo}
    for name, t in (("stage", stage), ("hi", hi), ("lo", lo)):
        if t.dtype != torch.int32 or tuple(t.shape) != (want[name], 8) or not t.is_contiguous():
            raise ValueError(f"expected a dense [{want[name]}, 8] int32 {name} table, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if t.device != x.device:
            raise ValueError(f"{name} table on {t.device}, data on {x.device}")


def ntt_transform(x: torch.Tensor, tables: PassTables, scale: int | None = None,
                  plan=None) -> torch.Tensor:
    """Each of the B transforms of the [16, B, n] x (natural order in and
    out) into a new dense tensor, every output times the standard-form
    ``scale`` when it is given: on the card one launch of the pass kernel a
    pass of ``plan`` (:func:`pass_plan` by default: one launch up to 2^11
    points, two up to 2^22); on the CPU :func:`ntt_passes_plain`."""
    log_n = _check_batch(x)
    if not _on_cuda(x):
        return ntt_passes_plain(x, tables, scale)
    from ._build import library

    _check_tables(x, tables, log_n)
    x = x.contiguous()
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    plan = pass_plan(log_n, x.shape[1]) if plan is None else tuple(plan)
    # the passes' packed intermediate: 8 words an element
    scratch = torch.empty((x.shape[1] << log_n, 8), dtype=torch.int32, device=x.device) \
        if len(plan) > 1 else None
    steps = (ctypes.c_int * (4 * len(plan)))(*[v for step in plan for v in step])
    stage, hi, lo = tables.packed
    scale_ptr = None if scale is None else ctypes.addressof(_scale_words(scale))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = library("ntt_kernels").swt_ntt_transform(
            x.data_ptr(), out.data_ptr(), None if scratch is None else scratch.data_ptr(),
            x.shape[1], log_n, ctypes.addressof(steps), len(plan), stage.data_ptr(),
            stage.shape[0].bit_length(), hi.data_ptr(), lo.data_ptr(), tables.log_lo,
            FR.p_words_ptr, FR.n0_32, FR.one_words_ptr, scale_ptr, stream)
    _raise_on(rc, "ntt_pass")
    for _ in plan:
        count_launch("ntt_pass")
    return out


def kernel_resources() -> dict:
    """Registers, local (spill) bytes and the thread limit a thread of the
    pass kernel, as the card's compiler built it, the larger of its two
    builds (stages one at a time, and in pairs: ``by_build``), and the
    shared memory a block may opt in to on the current card."""
    from ._build import library

    out = (ctypes.c_int * 6)()
    _raise_on(library("ntt_kernels").swt_ntt_kernel_resources(ctypes.addressof(out)),
              "ntt_pass kernel attributes")
    by_build = {"single": {"registers": out[0], "local_bytes": out[1]},
                "pairs": {"registers": out[4], "local_bytes": out[5]}}
    return {"registers": max(out[0], out[4]), "local_bytes": max(out[1], out[5]),
            "max_threads": out[2], "smem_limit": out[3], "by_build": by_build}

"""Complete BLS12-377 G1 point adds in one launch: the three kernels of
``csrc/g1_kernels.cu`` and their plain PyTorch versions.

Port of ``simpleworks_tpu/ops/g1_fused_pallas.py``, of the MSM's bucket
accumulate scan around its mixed add, and of its bucket combine (the
segment fold and the two suffix passes) around its Jacobian add.  A point is a tuple of limb-major
``[24, B]`` ``torch.int32`` Fq Montgomery planes: Jacobian (X, Y, Z) with
Z = 0 the identity, or affine (x, y) with x = y = 0 the identity.

* :func:`fused_add` — Jacobian + Jacobian (add-2007-bl, 16 multiplies);
* :func:`madd_accumulate` — a Jacobian accumulator per lane plus, row after
  row, the affine table point that the row's index names where its flag
  holds (madd-2007-bl, 11 multiplies an add): the MSM's whole bucket
  accumulate of one group in one launch;
* :func:`fused_madd` — Jacobian + affine, the one-row accumulate;
* :func:`bucket_combine` — a group's bucket sums to its window sums
  Σ_d d·S_d: the segment fold, then two suffix passes of Jacobian adds,
  every step in one launch.

The adds are complete: the equal-x cases double (dbl-2009-l) or cancel, and
the identities pass the other operand through, selected in the reference
kernels' order.  On CUDA tensors each wrapper launches its kernel (one
launch, counted in ``LAUNCHES``) or raises; on CPU tensors it runs its plain
version, the same formula over the field kernels' plain versions, which
runs on any device.  The formulas here, given the field ops of
:mod:`.mont_mul`, are also the composed adds of :mod:`.g1_limb`.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.device import FQ
from ._build import LAUNCHES, count_launch
from .mont_mul import (
    _check, _on_cuda, _raise_on, mod_add_plain, mod_sub_plain, mont_mul_plain,
)

__all__ = ["fused_add", "fused_madd", "madd_accumulate", "bucket_combine", "fused_add_plain",
           "fused_madd_plain", "madd_accumulate_plain", "bucket_combine_plain"]

#: 16-bit limbs of an affine table row: x, then y
ROW_LIMBS = 2 * FQ.n_limbs


class PlainFq:
    """Fq ops on [24, B] tensors through the field kernels' plain versions."""

    @staticmethod
    def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mont_mul_plain(a, b, FQ)

    @staticmethod
    def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mod_add_plain(a, b, FQ)

    @staticmethod
    def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mod_sub_plain(a, b, FQ)

    @staticmethod
    def is_zero(a: torch.Tensor) -> torch.Tensor:
        return (a == 0).all(dim=0)

    @staticmethod
    def select(cond: torch.Tensor, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """cond: [B] bool; a/b: [24, B]."""
        return torch.where(cond[None, :], a, b)


# ------------------------------------------------------------ the formulas --


def one(batch: int, device) -> torch.Tensor:
    return FQ.one(batch, device).contiguous()


def identity(batch: int, device):
    o = one(batch, device)
    return o, o, torch.zeros_like(o)


def select_point(cond, p, q):
    return tuple(torch.where(cond[None, :], a, b) for a, b in zip(p, q))


def double_formula(p, f):
    """Jacobian doubling (dbl-2009-l, a = 0) over the field ops ``f``; Z = 0
    in gives Z = 0 out."""
    X1, Y1, Z1 = p
    A = f.mul(X1, X1)
    B = f.mul(Y1, Y1)
    C = f.mul(B, B)
    t = f.add(X1, B)
    D = f.sub(f.sub(f.mul(t, t), A), C)
    D = f.add(D, D)
    E = f.add(f.add(A, A), A)
    F = f.mul(E, E)
    X3 = f.sub(F, f.add(D, D))
    eight_c = f.add(C, C)
    eight_c = f.add(eight_c, eight_c)
    eight_c = f.add(eight_c, eight_c)
    Y3 = f.sub(f.mul(E, f.sub(D, X3)), eight_c)
    Z3 = f.mul(f.add(Y1, Y1), Z1)
    return (X3, Y3, Z3)


def _with_doubling(doubles, p, general, f):
    """``general`` with the lanes of ``doubles`` replaced by 2p.  On the CPU,
    where reading the mask costs no device wait, the doubling is skipped
    when no lane needs it (same values); elsewhere it always runs."""
    if doubles.device.type == "cpu" and not bool(doubles.any()):
        return general
    return select_point(doubles, double_formula(p, f), general)


def add_formula(p, q, f):
    """Complete (branchless) Jacobian addition over the field ops ``f``."""
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    Z1Z1 = f.mul(Z1, Z1)
    Z2Z2 = f.mul(Z2, Z2)
    U1 = f.mul(X1, Z2Z2)
    U2 = f.mul(X2, Z1Z1)
    S1 = f.mul(f.mul(Y1, Z2), Z2Z2)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, U1)
    rr = f.sub(S2, S1)
    rr2 = f.add(rr, rr)
    I = f.mul(f.add(H, H), f.add(H, H))
    J = f.mul(H, I)
    V = f.mul(U1, I)
    X3 = f.sub(f.sub(f.mul(rr2, rr2), J), f.add(V, V))
    SJ = f.mul(S1, J)
    Y3 = f.sub(f.mul(rr2, f.sub(V, X3)), f.add(SJ, SJ))
    Zsum = f.add(Z1, Z2)
    Z3 = f.mul(f.sub(f.sub(f.mul(Zsum, Zsum), Z1Z1), Z2Z2), H)
    general = (X3, Y3, Z3)

    h_zero = f.is_zero(H)
    r_zero = f.is_zero(rr)
    p_ident = f.is_zero(Z1)
    q_ident = f.is_zero(Z2)
    ident = identity(X3.shape[1], X3.device)

    # same x: equal points double, opposite points cancel
    out = _with_doubling(h_zero & r_zero, p, general, f)
    out = select_point(h_zero & ~r_zero & ~p_ident & ~q_ident, ident, out)
    out = select_point(q_ident, p, out)
    return select_point(p_ident, q, out)


def madd_formula(p, q_affine, f):
    """Complete mixed addition over the field ops ``f``: Jacobian ``p`` +
    affine ``q = (X2, Y2)`` (madd-2007-bl, Z2 = 1)."""
    X1, Y1, Z1 = p
    X2, Y2 = q_affine
    Z1Z1 = f.mul(Z1, Z1)
    U2 = f.mul(X2, Z1Z1)
    S2 = f.mul(f.mul(Y2, Z1), Z1Z1)
    H = f.sub(U2, X1)
    rr = f.sub(S2, Y1)
    HH = f.mul(H, H)
    I = f.add(f.add(HH, HH), f.add(HH, HH))
    J = f.mul(H, I)
    r2 = f.add(rr, rr)
    V = f.mul(X1, I)
    X3 = f.sub(f.sub(f.mul(r2, r2), J), f.add(V, V))
    YJ = f.mul(Y1, J)
    Y3 = f.sub(f.mul(r2, f.sub(V, X3)), f.add(YJ, YJ))
    Zsum = f.add(Z1, H)
    Z3 = f.sub(f.sub(f.mul(Zsum, Zsum), Z1Z1), HH)
    general = (X3, Y3, Z3)

    h_zero = f.is_zero(H)
    r_zero = f.is_zero(rr)
    p_ident = f.is_zero(Z1)
    q_ident = f.is_zero(X2) & f.is_zero(Y2)
    B = X3.shape[1]

    out = _with_doubling(h_zero & r_zero & ~p_ident & ~q_ident, p, general, f)
    out = select_point(h_zero & ~r_zero & ~p_ident & ~q_ident, identity(B, X3.device), out)
    out = select_point(p_ident, (X2, Y2, one(B, X3.device)), out)
    return select_point(q_ident, p, out)


def fused_add_plain(p3, q3):
    """The plain version of :func:`fused_add`, on any device."""
    return add_formula(p3, q3, PlainFq)


def fused_madd_plain(p3, q2):
    """The plain version of :func:`fused_madd`, on any device."""
    return madd_formula(p3, q2, PlainFq)


def madd_accumulate_plain(acc3, rows, idx, valid):
    """The plain version of :func:`madd_accumulate`, on any device: one
    gather, mixed add and select a row."""
    lanes = idx.shape[1]
    acc = identity(lanes, rows.device) if acc3 is None else tuple(acc3)
    for d in range(idx.shape[0]):
        pts = rows.index_select(0, idx[d]).t().contiguous()  # [48, lanes]
        added = fused_madd_plain(acc, (pts[: FQ.n_limbs], pts[FQ.n_limbs :]))
        acc = select_point(valid[d], added, acc)
    return acc


def bucket_combine_plain(acc3, w_count: int, segs: int, b: int, add=fused_add_plain):
    """The plain version of :func:`bucket_combine`, on any device: one
    ``add`` of whole planes a step (``fused_add_plain`` unless a caller
    passes another add)."""
    dev = acc3[0].device
    acc = tuple(acc3)
    # fold the segment axis: [24, W, S, B] -> [24, W, B]
    s = segs
    while s > 1:
        half = s // 2
        t4 = tuple(a.reshape(24, w_count, s, b) for a in acc)
        left = tuple(a[:, :, :half].reshape(24, w_count * half * b) for a in t4)
        right = tuple(a[:, :, half:].reshape(24, w_count * half * b) for a in t4)
        acc = add(left, right)
        s = half

    ident = tuple(a.reshape(24, w_count, b) for a in identity(w_count * b, dev))

    def suffix_pass(t):
        """Inclusive suffix sums along the bucket axis: T_j ← Σ_{d≥j} T_d."""
        k = 1
        while k < b:
            shifted = tuple(
                torch.cat([a[:, :, k:], i[:, :, :k]], dim=2).reshape(24, w_count * b)
                for a, i in zip(t, ident)
            )
            flat = tuple(a.reshape(24, w_count * b) for a in t)
            t = tuple(a.reshape(24, w_count, b) for a in add(flat, shifted))
            k <<= 1
        return t

    # Σ_d d·S_d: T_j = Σ_{d≥j} S_d, then with T_0 zeroed (digit 0 has weight
    # 0) lane 0 of a second suffix pass is Σ_{j≥1} T_j = Σ_d d·S_d
    t = suffix_pass(tuple(a.reshape(24, w_count, b) for a in acc))
    t = tuple(torch.cat([i[:, :, :1], a[:, :, 1:]], dim=2) for a, i in zip(t, ident))
    t = suffix_pass(t)
    return tuple(a[:, :, 0] for a in t)


# ------------------------------------------------------------------ wrappers --


def _launch_add(planes) -> tuple:
    from ._build import library

    x = planes[0]
    B = x.shape[1]
    out = torch.empty((3, FQ.n_limbs, B), dtype=torch.int32, device=x.device)
    if B == 0:
        return out[0], out[1], out[2]
    views = (ctypes.c_int64 * 18)(
        *[v for t in planes for v in (t.data_ptr(), t.stride(0), t.stride(1))])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = library("g1_kernels").swt_g1_fused_add(
            ctypes.addressof(views), out.data_ptr(), B, FQ.p_words_ptr, FQ.n0_32,
            FQ.one_words_ptr, stream)
    _raise_on(rc, "g1_fused_add")
    count_launch("g1_fused_add")
    return out[0], out[1], out[2]


def _check_accumulate(acc3, rows, idx, valid) -> None:
    if rows.dtype != torch.int32 or rows.dim() != 2 or rows.shape[1] != ROW_LIMBS:
        raise ValueError(f"expected an [n, {ROW_LIMBS}] int32 table of affine rows, got "
                         f"{rows.dtype} {tuple(rows.shape)}")
    if idx.dtype != torch.int64 or valid.dtype != torch.bool or idx.dim() != 2 \
            or valid.shape != idx.shape:
        raise ValueError(f"expected int64 idx and bool valid of one [D, lanes] shape, got "
                         f"{idx.dtype} {tuple(idx.shape)} and {valid.dtype} {tuple(valid.shape)}")
    devices = {t.device for t in (rows, idx, valid)}
    if acc3 is not None:
        if len(acc3) != 3:
            raise ValueError("the starting accumulator is an (X, Y, Z) triple")
        _check(FQ, *acc3)
        if acc3[0].shape[1] != idx.shape[1]:
            raise ValueError(f"accumulator of {acc3[0].shape[1]} lanes, grid of {idx.shape[1]}")
        devices.add(acc3[0].device)
    if len(devices) != 1:
        raise ValueError(f"device mismatch: {sorted(map(str, devices))}")


def _launch_accumulate(acc3, rows, idx, valid) -> tuple:
    """One launch of the accumulate kernel (CUDA tensors)."""
    from ._build import library

    if not (rows.is_contiguous() and idx.is_contiguous() and valid.is_contiguous()):
        raise ValueError("the table, idx and valid must be contiguous")
    if rows.data_ptr() % 16:
        raise ValueError("the table's rows are read as 16-byte vectors: 16-byte align it")
    depth, lanes = idx.shape
    out = torch.empty((3, FQ.n_limbs, lanes), dtype=torch.int32, device=rows.device)
    if lanes == 0:
        return out[0], out[1], out[2]
    views = None
    if acc3 is not None:
        views = (ctypes.c_int64 * 9)(
            *[v for t in acc3 for v in (t.data_ptr(), t.stride(0), t.stride(1))])
    with torch.cuda.device(rows.device):
        stream = torch.cuda.current_stream(rows.device).cuda_stream
        rc = library("g1_kernels").swt_g1_madd_accumulate(
            None if views is None else ctypes.addressof(views), rows.data_ptr(), idx.data_ptr(),
            valid.data_ptr(), depth, lanes, out.data_ptr(), FQ.p_words_ptr, FQ.n0_32,
            FQ.one_words_ptr, stream)
    _raise_on(rc, "g1_fused_madd")
    count_launch("g1_fused_madd")
    return out[0], out[1], out[2]


def _check_combine(acc3, w_count: int, segs: int, b: int) -> None:
    if len(acc3) != 3:
        raise ValueError("the bucket sums are an (X, Y, Z) triple")
    _check(FQ, *acc3)
    for name, v in (("segments", segs), ("buckets", b)):
        if v < 1 or v & (v - 1):
            raise ValueError(f"the {name} must be a power of two, got {v}")
    if b < 2:
        raise ValueError(f"a window needs at least 2 buckets, got {b}")
    if w_count < 1 or acc3[0].shape[1] != w_count * segs * b:
        raise ValueError(f"{acc3[0].shape[1]} lanes are not {w_count} windows x {segs} segments "
                         f"x {b} buckets")
    if not all(a.is_contiguous() for a in acc3):
        raise ValueError("the bucket-sum planes must be contiguous")


def _launch_combine(acc3, w_count: int, segs: int, b: int) -> tuple:
    """One cooperative launch of the combine kernel (CUDA tensors)."""
    from ._build import library

    dev = acc3[0].device
    out = torch.empty((3, FQ.n_limbs, w_count), dtype=torch.int32, device=dev)
    cap = w_count * b * max(segs // 2, 1)  # lanes of the widest step's output
    bufs = torch.empty((2, 3 * FQ.n_limbs // 2, cap), dtype=torch.int32, device=dev)
    views = (ctypes.c_int64 * 9)(
        *[v for t in acc3 for v in (t.data_ptr(), t.stride(0), t.stride(1))])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = library("g1_kernels").swt_g1_bucket_combine(
            ctypes.addressof(views), bufs[0].data_ptr(), bufs[1].data_ptr(), w_count, segs, b,
            out.data_ptr(), FQ.p_words_ptr, FQ.n0_32, FQ.one_words_ptr, stream)
    _raise_on(rc, "g1_bucket_combine")
    count_launch("g1_bucket_combine")
    return out[0], out[1], out[2]


def kernel_resources() -> dict:
    """Registers and local (spill) bytes a thread of each kernel, as the
    card's compiler built them."""
    from ._build import library

    names = ("g1_fused_add", "g1_fused_madd", "g1_bucket_combine")
    out = (ctypes.c_int * (2 * len(names)))()
    _raise_on(library("g1_kernels").swt_g1_kernel_resources(ctypes.addressof(out)),
              "g1 kernel attributes")
    return {name: {"registers": out[2 * k], "local_bytes": out[2 * k + 1]}
            for k, name in enumerate(names)}


def fused_add(p3, q3):
    """Complete Jacobian addition p3 + q3 of ([24, B],)*3 Fq planes."""
    planes = (*p3, *q3)
    if len(planes) != 6:
        raise ValueError("fused_add takes two (X, Y, Z) coordinate triples")
    _check(FQ, *planes)
    if not _on_cuda(planes[0]):
        return fused_add_plain(p3, q3)
    return _launch_add(planes)


def madd_accumulate(acc3, rows, idx, valid):
    """The bucket accumulate of one MSM group: lane j starts from ``acc3``
    (([24, lanes],)*3 Jacobian planes; None is the identity) and adds, for
    each row d in order, the affine table row ``rows[idx[d, j]]`` where
    ``valid[d, j]`` holds.  ``rows``: [n, 48] int32 (x limbs, then y limbs);
    ``idx``: [D, lanes] int64, each entry a row of the table (the kernel
    reads it unchecked); ``valid``: [D, lanes] bool.  One kernel launch on
    CUDA tensors."""
    _check_accumulate(acc3, rows, idx, valid)
    if not _on_cuda(rows):
        return madd_accumulate_plain(acc3, rows, idx, valid)
    return _launch_accumulate(acc3, rows, idx, valid)


def fused_madd(p3, q2):
    """Complete mixed addition of Jacobian ([24, B],)*3 p3 and affine
    ([24, B],)*2 q2 (x = y = 0 the identity): the one-row accumulate, with
    q2 as a row-major table and every lane adding its own row."""
    planes = (*p3, *q2)
    if len(planes) != 5:
        raise ValueError("fused_madd takes an (X, Y, Z) triple and an (x, y) pair")
    _check(FQ, *planes)
    if not _on_cuda(planes[0]):
        return fused_madd_plain(p3, q2)
    B = planes[0].shape[1]
    rows = torch.cat(q2).t().contiguous()  # [B, 48]
    idx = torch.arange(B, device=rows.device).reshape(1, B)
    valid = torch.ones((1, B), dtype=torch.bool, device=rows.device)
    return madd_accumulate(p3, rows, idx, valid)


def bucket_combine(acc3, w_count: int, segs: int, b: int):
    """The bucket combine of one MSM group: ``acc3`` holds the bucket sums
    S_{w,s,d} (([24, W·S·b],)*3 contiguous Jacobian planes, lane
    w·S·b + s·b + d, as :func:`madd_accumulate` leaves them); the S segments
    of each bucket are folded into one, and two inclusive suffix passes over
    the b buckets give each window's Σ_d d·S_d, returned as ([24, W],)*3.
    S and b are powers of two, b >= 2.  One kernel launch on CUDA tensors."""
    _check_combine(acc3, w_count, segs, b)
    if not _on_cuda(acc3[0]):
        return bucket_combine_plain(acc3, w_count, segs, b)
    return _launch_combine(acc3, w_count, segs, b)

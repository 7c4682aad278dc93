"""Batched BLS12-377 Fr/Fq arithmetic on limb-major tensors: the four
kernels of the port and their plain PyTorch versions.

Port of ``simpleworks_tpu/ops/mont_mul_pallas.py``.  A field vector is a
limb-major ``[L, B]`` ``torch.int32`` tensor of 16-bit limbs in Montgomery
form (L = 16 for Fr, R = 2^256; L = 24 for Fq, R = 2^384) — value for value
the reference's ``uint32`` arrays.

Each public op takes two such tensors of one shape (broadcast a ``[L, 1]``
column with ``.expand``; sliced views are fine, the kernels take strides):

* a tensor on the CPU goes to the plain version (int64 limb arithmetic —
  torch has no uint32 add/shift/compare on the CPU);
* a tensor on CUDA goes to the CUDA kernel of ``csrc/field_kernels.cu``, or
  the wrapper raises.  There is no fallback between the two.

``LAUNCHES`` (kept in :mod:`._build` with the NTT's count) counts kernel
launches per op, so a run can show that its path went through the kernels;
only a CUDA launch adds to it.

The pow walks :func:`pow_schedule` (a sliding window of ``POW_WINDOW`` bits)
on both routes: the plain version with ``mont_mul_plain``, the kernel with
its carry-chain squaring and multiply; both give x^e mod p exactly.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache, wraps

import torch

from ..fields.device import FQ, FR, LIMB_BITS, LIMB_MASK, LimbField
from ._build import LAUNCHES, count_launch, reset_launches

__all__ = [
    "FR", "FQ", "LimbField", "LAUNCHES", "reset_launches", "mont_mul", "mod_add", "mod_sub",
    "mont_pow", "mont_mul_plain", "mod_add_plain", "mod_sub_plain", "mont_pow_plain",
    "POW_WINDOW", "pow_schedule", "pow_table_size", "kernel_resources",
]

#: the pow's window: its exponent's digits have at most this many bits (the
#: kernel's table holds the odd powers below 2^4; 4 ran 1.4 % faster than 5
#: at the prove's widths on the H100, 1.1 % slower on narrow batches)
POW_WINDOW = 4


# ------------------------------------------------------------ plain versions --


def _normalize(v: torch.Tensor):
    """Carry-propagate int64 limb rows [L, B] (any sign, any size) into
    16-bit limbs -> (limbs mod 2^(16L), carry out of the top limb).

    Parallel passes (every limb sheds its carry at once) until no carry is
    left: two or three for random data, at most about L when a carry
    ripples through a run of 0xFFFF limbs."""
    top = torch.zeros_like(v[0])
    while True:
        c = v >> LIMB_BITS  # arithmetic shift: a borrow is a carry of −1
        if not bool(c.any()):
            return v, top
        v = v & LIMB_MASK
        v[1:] += c[:-1]
        top = top + c[-1]


@lru_cache(maxsize=8)
def _p_col(field: LimbField, device: torch.device) -> torch.Tensor:
    """[L, 1] int64: the limbs of p, made once a field and device."""
    return field.col(field.p_limbs, device, torch.int64)


@lru_cache(maxsize=8)
def _pow3(n_limbs: int, device: torch.device) -> torch.Tensor:
    """[L, 1] int64: 3^i for limb i."""
    return torch.tensor([3**i for i in range(n_limbs)], dtype=torch.int64, device=device)[:, None]


def _geq(x: torch.Tensor, field: LimbField) -> torch.Tensor:
    """x ≥ p for 16-bit limb rows [L, B]: the sign of the most significant
    limb that differs, as the sign of Σ sign(x_i − p_i)·3^i."""
    s = torch.sign(x - _p_col(field, x.device))
    return (s * _pow3(field.n_limbs, x.device)).sum(dim=0) >= 0


def _reduce_once(v: torch.Tensor, carry: torch.Tensor, field: LimbField) -> torch.Tensor:
    """V = carry·2^(16L) + v < 2p -> V mod p (subtract p once when V ≥ p)."""
    diff, _ = _normalize(v - _p_col(field, v.device))
    return torch.where((carry > 0) | _geq(v, field), diff, v).to(torch.int32)


@lru_cache(maxsize=8)
def _diagonals(n_limbs: int, device: torch.device) -> torch.Tensor:
    """[L·L] int64: row i·L + j of the limb outer product adds to column i + j."""
    i = torch.arange(n_limbs, device=device)
    return (i[:, None] + i[None, :]).reshape(-1)


#: lanes a plain binary op works on at once on the CPU: its int64
#: temporaries then stay in the caches (2-4x faster than one pass over a
#: wide batch, and the limb outer product never takes more than a few MB)
PLAIN_CHUNK = 8192


def _by_chunks(op):
    """``op(a, b, field)`` on PLAIN_CHUNK lanes at a time on the CPU (same
    values); one pass elsewhere, where every chunk would be more launches."""
    @wraps(op)
    def chunked(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
        B = a.shape[1]
        if B <= PLAIN_CHUNK or a.device.type != "cpu":
            return op(a, b, field)
        return torch.cat([op(a[:, i : i + PLAIN_CHUNK], b[:, i : i + PLAIN_CHUNK], field)
                          for i in range(0, B, PLAIN_CHUNK)], dim=1)
    return chunked


@_by_chunks
def mont_mul_plain(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
    """a·b·R⁻¹ mod p: schoolbook product, 16-bit REDC, one conditional
    subtract — the arithmetic of the Pallas ``_mul_body``."""
    L = field.n_limbs
    a64, b64 = a.to(torch.int64), b.to(torch.int64)
    t = torch.zeros((2 * L + 1, a.shape[1]), dtype=torch.int64, device=a.device)
    # column sums of the limb outer product stay < 2L·2^32: no carries yet
    t.index_add_(0, _diagonals(L, a.device), (a64[:, None, :] * b64[None, :, :]).reshape(L * L, -1))
    p = _p_col(field, a.device)
    rows = t.unbind(0)
    for i in range(L):
        m = (rows[i] * field.n0_16) & LIMB_MASK  # t[i] < 2^40: no int64 overflow
        t[i : i + L] += m * p
        rows[i + 1].add_(rows[i] >> LIMB_BITS)  # row i is now ≡ 0 mod 2^16
    res, carry = _normalize(t[L:])  # rows L..2L: V < 2p, so row 2L is 0 or 1
    return _reduce_once(res[:L], res[L] + carry, field)


@_by_chunks
def mod_add_plain(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
    """(a + b) mod p: carry-propagate, then subtract p when the sum is ≥ p."""
    res, carry = _normalize(a.to(torch.int64) + b.to(torch.int64))
    return _reduce_once(res, carry, field)


@_by_chunks
def mod_sub_plain(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
    """(a − b) mod p: borrow-propagate, then add p back when it wrapped."""
    diff, borrow = _normalize(a.to(torch.int64) - b.to(torch.int64))
    plus, _ = _normalize(diff + _p_col(field, a.device))
    return torch.where(borrow < 0, plus, diff).to(torch.int32)


@lru_cache(maxsize=32)
def pow_schedule(exponent: int, window: int) -> tuple[tuple[int, int], ...]:
    """``exponent`` as Σ digit·2^shift over a sliding window, from the top:
    each digit odd and below 2^window, the shifts falling; () for 0.  A pow
    starts from the top digit's power of x, then for each later digit
    squares (previous shift − shift) times and multiplies by x^digit, and
    ends with as many squarings as the last shift."""
    if exponent < 0 or window < 1:
        raise ValueError("pow_schedule takes a non-negative exponent and a window of >= 1 bit")
    digits = []
    top = exponent.bit_length() - 1
    while top >= 0:
        if not (exponent >> top) & 1:
            top -= 1
            continue
        low = max(top - window + 1, 0)
        while not (exponent >> low) & 1:  # the window ends in a set bit: odd digit
            low += 1
        digits.append(((exponent >> low) & ((1 << (top - low + 1)) - 1), low))
        top = low - 1
    return tuple(digits)


def pow_table_size(schedule) -> int:
    """The odd powers x, x^3, .. that ``schedule`` reads: up to its largest
    digit (at least one)."""
    return max((digit for digit, _ in schedule), default=1) // 2 + 1


def mont_pow_plain(x: torch.Tensor, exponent: int, field: LimbField) -> torch.Tensor:
    """x^e elementwise along ``pow_schedule(e, POW_WINDOW)`` (0 maps to 0
    for e > 0; e = 0 gives the Montgomery one)."""
    schedule = pow_schedule(exponent, POW_WINDOW)
    if not schedule:
        return field.one(x.shape[1], x.device).contiguous()
    table, n_table = [x], pow_table_size(schedule)
    if n_table > 1:
        x2 = mont_mul_plain(x, x, field)
        while len(table) < n_table:
            table.append(mont_mul_plain(table[-1], x2, field))
    acc = table[schedule[0][0] >> 1]
    for (_, prev), (digit, shift) in zip(schedule, schedule[1:]):
        for _ in range(prev - shift):
            acc = mont_mul_plain(acc, acc, field)
        acc = mont_mul_plain(acc, table[digit >> 1], field)
    for _ in range(schedule[-1][1]):
        acc = mont_mul_plain(acc, acc, field)
    return x.clone(memory_format=torch.contiguous_format) if acc is x else acc


# ------------------------------------------------------------------ wrappers --


def _check(field: LimbField, *xs: torch.Tensor) -> None:
    shape = xs[0].shape
    for x in xs:
        if x.dtype != torch.int32:
            raise TypeError(f"field vectors are torch.int32 limb tensors, got {x.dtype}")
        if x.dim() != 2 or x.shape[0] != field.n_limbs:
            raise ValueError(
                f"expected a [{field.n_limbs}, B] {field.params.name} limb tensor, got {tuple(x.shape)}"
            )
        if x.shape != shape:
            raise ValueError(f"shape mismatch: {tuple(x.shape)} vs {tuple(shape)}")
        if x.device != xs[0].device:
            raise ValueError(f"device mismatch: {x.device} vs {xs[0].device}")


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"unsupported device {x.device}")
    return True


def _raise_on(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed with CUDA error {rc}")


def _binary(name: str, symbol: str, a: torch.Tensor, b: torch.Tensor, field: LimbField):
    from ._build import library

    fn = getattr(library(), symbol)
    L, B = a.shape
    out = torch.empty((L, B), dtype=torch.int32, device=a.device)
    if B == 0:
        return out
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream(a.device).cuda_stream
        rc = fn(field.n_words, a.data_ptr(), a.stride(0), a.stride(1),
                b.data_ptr(), b.stride(0), b.stride(1), out.data_ptr(), B,
                field.p_words_ptr, field.n0_32, field.one_words_ptr, stream)
    _raise_on(rc, name)
    count_launch(name)
    return out


def mont_mul(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
    """Montgomery product a·b·R⁻¹ mod p of two [L, B] limb tensors."""
    _check(field, a, b)
    if not _on_cuda(a):
        return mont_mul_plain(a, b, field)
    return _binary("mont_mul", "swt_mont_mul", a, b, field)


def mod_add(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
    """(a + b) mod p of two [L, B] limb tensors."""
    _check(field, a, b)
    if not _on_cuda(a):
        return mod_add_plain(a, b, field)
    return _binary("mod_add", "swt_mod_add", a, b, field)


def mod_sub(a: torch.Tensor, b: torch.Tensor, field: LimbField) -> torch.Tensor:
    """(a − b) mod p of two [L, B] limb tensors."""
    _check(field, a, b)
    if not _on_cuda(a):
        return mod_sub_plain(a, b, field)
    return _binary("mod_sub", "swt_mod_sub", a, b, field)


@lru_cache(maxsize=32)
def _pow_steps(exponent: int):
    """The kernel's steps of ``pow_schedule(exponent, POW_WINDOW)``: the top
    digit, then (squarings << 16 | digit) a later digit, then the trailing
    squarings with digit 0 -> (uint32 array, step count, table size)."""
    schedule = pow_schedule(exponent, POW_WINDOW)
    steps = [digit for digit, _ in schedule[:1]]
    for (_, prev), (digit, shift) in zip(schedule, schedule[1:]):
        steps.append((prev - shift) << 16 | digit)
    if schedule and schedule[-1][1]:
        steps.append(schedule[-1][1] << 16)
    words = (ctypes.c_uint32 * max(1, len(steps)))(*steps)
    return words, len(steps), pow_table_size(schedule)


def mont_pow(x: torch.Tensor, exponent: int, field: LimbField) -> torch.Tensor:
    """x^exponent elementwise on an [L, B] Montgomery limb tensor (a fixed
    exponent of at most 384 bits; the Fermat inverse is e = p − 2)."""
    _check(field, x)
    if exponent < 0 or exponent.bit_length() > 384:
        raise ValueError("exponent must be a non-negative integer of at most 384 bits")
    if not _on_cuda(x):
        return mont_pow_plain(x, exponent, field)
    from ._build import library

    L, B = x.shape
    out = torch.empty((L, B), dtype=torch.int32, device=x.device)
    if B == 0:
        return out
    steps, n_steps, n_table = _pow_steps(exponent)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = library().swt_mont_pow(
            field.n_words, x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), B,
            field.p_words_ptr, field.n0_32, field.one_words_ptr,
            ctypes.addressof(steps), n_steps, n_table, stream,
        )
    _raise_on(rc, "mont_pow")
    count_launch("mont_pow")
    return out


def kernel_resources() -> dict:
    """Registers and local (spill) bytes a thread of the pow kernel, by the
    field's 32-bit words (8: Fr, 12: Fq), as the card's compiler built it."""
    from ._build import library

    out = (ctypes.c_int * 4)()
    _raise_on(library().swt_field_kernel_resources(ctypes.addressof(out)), "field kernel attributes")
    return {n: {"registers": out[2 * k], "local_bytes": out[2 * k + 1]}
            for k, n in enumerate((8, 12))}

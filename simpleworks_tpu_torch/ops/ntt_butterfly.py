"""The radix-2 butterfly NTT's two kernels over BLS12-377 Fr, and their
plain PyTorch versions.

The transform of :mod:`..poly.ntt_device` (the port of
``simpleworks_tpu/poly/ntt_device.py``, the XLA butterfly NTT that the JAX
package runs on every backend that is not a TPU) is, over a batch of B
contiguous transforms of n = 2^log_n points ([16, B, n] int32 Montgomery
limbs):

* :func:`ntt_bitrev`: the bit-reversal permutation of each transform, out
  of place (the reference's gather by ``_bit_reverse_indices``,
  ``ntt_device.py:35-41, :81``);
* :func:`ntt_butterfly`, once a stage s = 0 .. log_n − 1, in place: with
  h = 2^s, each butterfly pairs lo (offset k of a block of 2h) with
  hi = lo + h, t = hi·w^k, lo ← lo + t, hi ← lo − t, where w^k is entry
  k·n/2h of one table of the n/2 Montgomery powers of ω (the reference's
  stage, ``ntt_device.py:82-88``); ``scale`` multiplies both outputs by a
  constant (the inverse's 1/n on its last stage, ``:89-90``).

A CUDA tensor launches the kernels of ``csrc/ntt_kernels.cu`` or the wrapper
raises; a CPU tensor takes the plain version beside each, over
:mod:`.mont_mul`'s plain multiply, add and subtract.  There is no fallback
between the two.  ``LAUNCHES["ntt_bitrev"]`` and ``["ntt_butterfly"]``
count the kernel launches.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import torch

from ..fields.device import FR, split_words
from ._build import count_launch
from .mont_mul import _on_cuda, _raise_on, mod_add_plain, mod_sub_plain, mont_mul_plain

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
    out_lo, out_hi = mod_add_plain(a, t, FR), mod_sub_plain(a, t, FR)
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

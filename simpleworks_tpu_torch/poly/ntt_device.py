"""The radix-2 butterfly NTT over Fr limb tensors: the transform of
``dvec.fft``/``ifft`` on the card and of the sharded plane's local columns
and rows.

Port of ``simpleworks_tpu/poly/ntt_device.py``, the XLA butterfly NTT that
the JAX package runs on every backend that is not a TPU (its MXU
DFT-as-matmul, :mod:`..ops.ntt` here, runs only on a TPU).  An iterative
Cooley–Tukey: the bit-reversal permutation, then log2(n) radix-2 stages,
each one launch of a kernel of :mod:`..ops.ntt_butterfly` over the whole
batch (the plain versions on a CPU tensor).  Natural order in and out;
outputs equal the host oracle (:func:`..poly.domain.ntt_host`) and the
reference's element for element.

Layout: the port's ``[16, n]`` int32 Montgomery limbs (the reference's
``[n, 16]`` uint32 transposed), batched as ``[16, B, n]``.

The twiddles are the reference's stage tables (``ntt_device.py:62-75``),
stored as one table of the n/2 Montgomery powers of ω (and one of ω⁻¹),
built on the transform's device by ``dvec.powers_vec``; stage s reads
entry k·n/2^(s+1).  The inverse's 1/n rides on the last stage.

Departures from the reference: ``n = 1`` is accepted (the identity), as the
port's ``dvec`` takes every power of two; the batched forms
``fft_mont_batch``/``ifft_mont_batch`` (the reference's
``parallel/ntt_sharded.py`` ``_batched_stage_transform``, with the same API
as :class:`..ops.ntt.LimbMatmulNTT`) scale the inverse by 1/n like the
single form; ``get_device_ntt`` takes the device.
"""

from __future__ import annotations

import threading
from functools import lru_cache

import torch

from ..device import resolve
from ..fields.bls12_377 import FR_MODULUS, Fr, fr_root_of_unity
from ..fields.device import DeviceField
from ..ops.ntt_butterfly import L, _log2, ntt_bitrev, ntt_butterfly

P = FR_MODULUS


@lru_cache(maxsize=None)
def fr_device_field() -> DeviceField:
    """The batched Fr surface."""
    return DeviceField(Fr.PARAMS)


class DeviceNTT:
    """Transform of one power-of-two size on one device (forward and
    inverse), its twiddle tables built once."""

    def __init__(self, n: int, device=None):
        from ..fields import dvec

        self.log_n = _log2(n)
        self.n = n
        self.device = resolve(device)
        self.df = fr_device_field()
        omega = fr_root_of_unity(n)
        half = max(n // 2, 1)
        self.twiddles_fwd = dvec.powers_vec(omega, half, self.device).contiguous()
        self.twiddles_inv = dvec.powers_vec(pow(omega, P - 2, P), half, self.device).contiguous()
        self.n_inv = pow(n, P - 2, P)

    def _check(self, x: torch.Tensor, batched: bool) -> None:
        dims = 3 if batched else 2
        if x.dim() != dims or x.shape[0] != L or x.shape[-1] != self.n or x.dtype != torch.int32:
            shape = f"[16, B, {self.n}]" if batched else f"[16, {self.n}]"
            raise ValueError(f"expected a {shape} int32 limb tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, transform tables on {self.device}")

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """[16, B, n] -> [16, B, n] (a new tensor; the inverse scaled by 1/n)."""
        y = ntt_bitrev(x)
        table = self.twiddles_inv if inverse else self.twiddles_fwd
        for stage in range(self.log_n):
            last = stage == self.log_n - 1
            ntt_butterfly(y, stage, table, self.n_inv if inverse and last else None)
        return y

    # -- Montgomery-form device API ------------------------------------------

    def fft_mont(self, x: torch.Tensor) -> torch.Tensor:
        """[16, n] coefficients -> evaluations over the size-n domain."""
        self._check(x, batched=False)
        return self._transform(x[:, None, :], inverse=False)[:, 0, :]

    def ifft_mont(self, x: torch.Tensor) -> torch.Tensor:
        """[16, n] evaluations -> coefficients (1/n folded in)."""
        self._check(x, batched=False)
        return self._transform(x[:, None, :], inverse=True)[:, 0, :]

    def fft_mont_batch(self, x: torch.Tensor) -> torch.Tensor:
        """B transforms at once, [16, B, n] -> [16, B, n]: one launch a
        stage over the whole batch."""
        self._check(x, batched=True)
        return self._transform(x, inverse=False)

    def ifft_mont_batch(self, x: torch.Tensor) -> torch.Tensor:
        """B inverse transforms at once (1/n folded in), [16, B, n]."""
        self._check(x, batched=True)
        return self._transform(x, inverse=True)

    # -- host int API (bit-exact against ntt_host) ------------------------------

    def fft(self, coeffs: list[int]) -> list[int]:
        """Standard-form coefficients (padded to n) -> evaluations."""
        from ..fields import dvec

        padded = list(coeffs) + [0] * (self.n - len(coeffs))
        return dvec.to_ints(self.fft_mont(dvec.from_ints(padded, self.device)))

    def ifft(self, evals: list[int]) -> list[int]:
        """Standard-form evaluations (exactly n) -> coefficients."""
        from ..fields import dvec

        if len(evals) != self.n:
            raise ValueError(f"expected {self.n} evaluations, got {len(evals)}")
        return dvec.to_ints(self.ifft_mont(dvec.from_ints(evals, self.device)))


_MEMO: dict = {}
_MEMO_MAX = 16
_MEMO_LOCK = threading.Lock()


def get_device_ntt(n: int, device=None) -> DeviceNTT:
    """The transform of size ``n`` on ``device`` (the card by default), its
    tables built once a size and device: under one lock, so that the proof
    pipeline's two threads never build the same tables twice."""
    device = resolve(device)
    key = (n, device)
    with _MEMO_LOCK:
        ntt = _MEMO.get(key)
        if ntt is None:
            ntt = DeviceNTT(n, device)
            if len(_MEMO) >= _MEMO_MAX:
                _MEMO.pop(next(iter(_MEMO)))
            _MEMO[key] = ntt
    return ntt

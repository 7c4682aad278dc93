"""The radix-2 NTT over Fr limb tensors: the transform of ``dvec.fft``/
``ifft`` on the card and of the sharded plane's local columns and rows.

Port of ``simpleworks_tpu/poly/ntt_device.py``, the XLA butterfly NTT that
the JAX package runs on every backend that is not a TPU (its MXU
DFT-as-matmul, :mod:`..ops.ntt` here, runs only on a TPU).  The reference
runs the bit-reversal permutation, then log2(n) radix-2 stages; this port
computes the same transform in passes of shared-memory tiles
(:func:`..ops.ntt_butterfly.ntt_transform`): a four-step split of n into
tiles of at most 2^11 points, one launch of the pass kernel a pass over the
whole batch (one launch up to 2^11 points, two up to 2^22), the bit
reversal folded into each pass's store and the inverse's 1/n into the last
pass; on a CPU tensor, the same passes over the plain field ops.  Natural
order in and out; outputs equal the host oracle
(:func:`..poly.domain.ntt_host`), the reference's and the stage route's
element for element (every value is canonical).

Layout: the port's ``[16, n]`` int32 Montgomery limbs (the reference's
``[n, 16]`` uint32 transposed), batched as ``[16, B, n]``.

The tables (:class:`..ops.ntt_butterfly.PassTables`, one set for ω and one
for ω⁻¹, built on the transform's device once a size by ``dvec.powers_vec``
under the memo's lock): the in-tile stage twiddles ω_2h^k of every stage up
to the largest tile (2^11 − 1 entries at most), and two tables of
ω^(i·2^⌈log2(n)/2⌉) and ω^i whose products give the four-step twiddles
(2^10 entries each at 2^20); on the card, packed into 32-bit words as well.
The stage route's table of the n/2 powers of ω (``twiddles_fwd``,
``twiddles_inv``, for ``ops.ntt_butterfly.stage_route``, which no path
runs) is built only when it is first read.

Departures from the reference: ``n = 1`` is accepted (the identity), as the
port's ``dvec`` takes every power of two; the batched forms
``fft_mont_batch``/``ifft_mont_batch`` (the reference's
``parallel/ntt_sharded.py`` ``_batched_stage_transform``, with the same API
as :class:`..ops.ntt.LimbMatmulNTT`) scale the inverse by 1/n like the
single form; ``get_device_ntt`` takes the device.
"""

from __future__ import annotations

import threading
from functools import cached_property, lru_cache

import torch

from ..device import resolve
from ..fields.bls12_377 import FR_MODULUS, Fr, fr_root_of_unity
from ..fields.device import DeviceField
from ..ops.ntt_butterfly import MAX_TILE_LOG, L, PassTables, _log2, ntt_transform, pack_words

P = FR_MODULUS


@lru_cache(maxsize=None)
def fr_device_field() -> DeviceField:
    """The batched Fr surface."""
    return DeviceField(Fr.PARAMS)


class DeviceNTT:
    """Transform of one power-of-two size on one device (forward and
    inverse), its twiddle tables built once."""

    def __init__(self, n: int, device=None):
        self.log_n = _log2(n)
        self.n = n
        self.device = resolve(device)
        self.df = fr_device_field()
        self.omega = fr_root_of_unity(n)
        self.omega_inv = pow(self.omega, P - 2, P)
        self.tables = {False: self._pass_tables(self.omega), True: self._pass_tables(self.omega_inv)}
        self.n_inv = pow(n, P - 2, P)

    def _pass_tables(self, omega: int) -> PassTables:
        """The pass kernel's tables of one direction (ω or ω⁻¹)."""
        from ..fields import dvec

        stage_log = min(max(self.log_n, 1), MAX_TILE_LOG)
        # ω_2h^k = ω_top^(k·top/2h), ω_top = ω^(n/top) the root of the largest tile
        top = dvec.powers_vec(pow(omega, self.n >> stage_log, P) if self.log_n else 1,
                              1 << (stage_log - 1), self.device)
        idx = torch.cat([torch.arange(1 << s, dtype=torch.int64) << (stage_log - 1 - s)
                         for s in range(stage_log)]).to(self.device)
        stage = top[:, idx].contiguous()
        log_lo = (self.log_n + 1) // 2
        lo = dvec.powers_vec(omega, 1 << log_lo, self.device).contiguous()
        hi = dvec.powers_vec(pow(omega, 1 << log_lo, P), 1 << (self.log_n - log_lo),
                             self.device).contiguous()
        packed = None
        if self.device.type == "cuda":
            packed = (pack_words(stage), pack_words(hi), pack_words(lo))
        return PassTables(stage, hi, lo, log_lo, packed)

    @cached_property
    def twiddles_fwd(self) -> torch.Tensor:
        """[16, n/2] Montgomery powers of ω: the stage route's table."""
        from ..fields import dvec

        return dvec.powers_vec(self.omega, max(self.n // 2, 1), self.device).contiguous()

    @cached_property
    def twiddles_inv(self) -> torch.Tensor:
        """[16, n/2] Montgomery powers of ω⁻¹: the stage route's table."""
        from ..fields import dvec

        return dvec.powers_vec(self.omega_inv, max(self.n // 2, 1), self.device).contiguous()

    def _check(self, x: torch.Tensor, batched: bool) -> None:
        dims = 3 if batched else 2
        if x.dim() != dims or x.shape[0] != L or x.shape[-1] != self.n or x.dtype != torch.int32:
            shape = f"[16, B, {self.n}]" if batched else f"[16, {self.n}]"
            raise ValueError(f"expected a {shape} int32 limb tensor, got "
                             f"{tuple(x.shape)} {x.dtype}")
        if x.device != self.device:
            raise ValueError(f"tensor on {x.device}, transform tables on {self.device}")

    def _transform(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        """[16, B, n] -> [16, B, n] (a new tensor; the inverse scaled by 1/n):
        the pass kernel on the card, its plain passes on the CPU."""
        return ntt_transform(x, self.tables[inverse], self.n_inv if inverse else None)

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
        pass over the whole batch."""
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

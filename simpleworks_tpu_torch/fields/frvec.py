"""FrVec: the prover's vector of BLS12-377 Fr elements, on one device.

Port of ``simpleworks_tpu/fields/frvec.py``.  The reference's FrVec is a host
numpy Montgomery array whose batch ops run in its native C++ runtime; the
port's FrVec is a thin class over a ``[16, N]`` ``torch.int32`` Montgomery
limb tensor (the :mod:`.dvec` layout) on an explicit device, and every op is
a :mod:`.dvec` call there: the index, the prover and the domain helpers run
on the card with no second host plane.  On a CPU tensor those calls, and the
fused multiply-add and the sparse accumulate here, take the host native
runtime (:mod:`..native`) when it is available, as the reference's do.

:class:`SpmvPlan` is the sparse accumulate ``out[rows[i]] += c_i·x[cols[i]]``
of the AHP (z_M = M·z and the t-evaluations).  Several terms land on one
output, so the sum is modular and accumulates: the terms are sorted by
output once, and a log-step segmented scan of modular adds folds each
output's run of terms; the plan is built once per matrix and reused.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from .. import native
from ..device import resolve
from . import dvec
from .bls12_377 import FR_MODULUS
from .device import FR, mont_scalar

P = FR_MODULUS


class FrVec:
    """Immutable-by-convention vector of Fr elements (Montgomery form)."""

    __slots__ = ("t",)

    def __init__(self, t: torch.Tensor):
        if t.dim() != 2 or t.shape[0] != dvec.L or t.dtype != torch.int32:
            raise ValueError(f"expected a [16, N] int32 limb tensor, got {tuple(t.shape)} {t.dtype}")
        self.t = t

    # -- construction ---------------------------------------------------------

    @staticmethod
    def from_ints(values: Sequence[int], device=None) -> "FrVec":
        return FrVec(dvec.from_ints(values, device))

    @staticmethod
    def from_std_array(std, device=None) -> "FrVec":
        """[N, 4] little-endian u64 standard-form values (each < p; the
        32-byte serde layout) -> FrVec on ``device``: one view as 16-bit
        limbs, one upload and one multiply by R² mod p into Montgomery form."""
        u16 = np.ascontiguousarray(std, dtype="<u8").view("<u2").reshape(-1, dvec.L)
        limbs = torch.from_numpy(np.ascontiguousarray(u16.T).astype(np.int32)).to(resolve(device))
        return FrVec(dvec.scale(limbs, mont_scalar(FR.r, FR, limbs.device)))

    def to_std_array(self) -> np.ndarray:
        """[N, 4] little-endian u64 standard-form values: out of Montgomery
        form on the device, then one copy to the host."""
        std = dvec.to_standard(self.t).cpu().numpy().astype("<u2")
        return np.ascontiguousarray(std.T).view("<u8").reshape(-1, 4)

    @staticmethod
    def from_device_limbs(limbs: torch.Tensor) -> "FrVec":
        """The [16, N] Montgomery limb tensor (the DeviceField layout) -> FrVec."""
        return FrVec(limbs)

    def to_device_limbs(self) -> torch.Tensor:
        """The [16, N] Montgomery limb tensor (the DeviceField layout)."""
        return self.t

    @staticmethod
    def zeros(n: int, device=None) -> "FrVec":
        return FrVec(dvec.zeros(n, device))

    @staticmethod
    def mont_scalar(value: int, device=None) -> torch.Tensor:
        """[16, 1] Montgomery column of one int."""
        return mont_scalar(value, FR, resolve(device))

    @staticmethod
    def powers(base: int, count: int, device=None) -> "FrVec":
        """[1, base, base², ...]."""
        return FrVec(dvec.powers_vec(base, count, device))

    @staticmethod
    def concat(parts: list["FrVec"]) -> "FrVec":
        return FrVec(torch.cat([p.t for p in parts], dim=1))

    # -- conversion -----------------------------------------------------------

    @property
    def device(self) -> torch.device:
        return self.t.device

    def to_ints(self) -> list[int]:
        return dvec.to_ints(self.t)

    def __len__(self) -> int:
        return self.t.shape[1]

    def copy(self) -> "FrVec":
        return FrVec(self.t.clone())

    def __getitem__(self, i):
        if isinstance(i, slice):
            return FrVec(self.t[:, i])
        i = range(len(self))[i]  # negative indices, and the IndexError
        return dvec.scalar_to_int(self.t[:, i : i + 1])

    # -- elementwise ops (Montgomery in and out) -------------------------------

    def _same(self, other: "FrVec") -> None:
        if len(self) != len(other):
            raise ValueError(f"length mismatch: {len(self)} vs {len(other)}")

    def __add__(self, other: "FrVec") -> "FrVec":
        self._same(other)
        return FrVec(dvec.add(self.t, other.t))

    def __sub__(self, other: "FrVec") -> "FrVec":
        self._same(other)
        return FrVec(dvec.sub(self.t, other.t))

    def __mul__(self, other: "FrVec") -> "FrVec":
        self._same(other)
        return FrVec(dvec.mul(self.t, other.t))

    def mul_add(self, other: "FrVec", addend: "FrVec") -> "FrVec":
        """self·other + addend."""
        self._same(other)
        self._same(addend)
        if dvec.host_native(self.t):
            words = native.limbs_to_words
            return FrVec(native.words_to_limbs(native.fr_mul_add_arr(
                words(self.t), words(other.t), words(addend.t))))
        return self * other + addend

    def scale(self, s: int) -> "FrVec":
        return FrVec(dvec.scale(self.t, self.mont_scalar(s, self.device)))

    def neg(self) -> "FrVec":
        return FrVec.zeros(len(self), self.device) - self

    def inv(self) -> "FrVec":
        """Elementwise inverse; zeros map to zero."""
        return FrVec(dvec.inv(self.t))

    def rsub_scalar(self, s: int) -> "FrVec":
        """s − self, elementwise."""
        return FrVec(dvec.rsub_scalar(self.t, self.mont_scalar(s, self.device)))

    def sum(self) -> int:
        """Σ elements (standard-form int; one small fetch)."""
        return dvec.limb_sums_to_int(dvec.sum_limbs_raw(self.t))

    # -- structural ------------------------------------------------------------

    def pad_to(self, n: int) -> "FrVec":
        return FrVec(dvec.pad_to(self.t, n))

    def nonzero_length(self) -> int:
        """Length after trimming trailing zeros (degree + 1 for coefficient
        vectors; one small fetch)."""
        nz = (self.t != 0).any(dim=0).nonzero()
        return int(nz[-1]) + 1 if nz.numel() else 0

    def is_zero(self) -> bool:
        return not bool((self.t != 0).any())

    # -- polynomial helpers -----------------------------------------------------

    def horner(self, z: int) -> int:
        """Σ self[i]·z^i at a standard-form point (one small fetch)."""
        if len(self) == 0:
            return 0
        return dvec.scalar_to_int(dvec.evaluate(self.t, z % P))

    def div_linear(self, z: int) -> tuple["FrVec", int]:
        """(quotient, remainder) of the division by (X − z)."""
        if len(self) == 0:
            return FrVec.zeros(0, self.device), 0
        quot, rem = dvec.divide_by_linear(self.t, z % P)
        return FrVec(quot), dvec.scalar_to_int(rem)

    # -- sparse accumulate ------------------------------------------------------

    @staticmethod
    def spmv(rows, cols, coeffs: "FrVec", x: "FrVec", out_len: int) -> "FrVec":
        """out[rows[i]] += coeffs[i]·x[cols[i]] (repeated rows accumulate)."""
        return SpmvPlan(rows, cols, coeffs, out_len).apply(x)

    def __repr__(self):
        return f"FrVec(len={len(self)}, device={self.device})"


def _offset(idx: torch.Tensor, batch: int, stride: int) -> torch.Tensor:
    """idx + b·stride for each b < batch, concatenated in b's order."""
    if batch == 1:
        return idx
    starts = torch.arange(batch, device=idx.device) * stride
    return (starts[:, None] + idx[None, :]).reshape(-1)


class SpmvPlan:
    """``out[rows[i]] += coeffs[i]·x[cols[i]]`` for one sparsity pattern and
    coefficient list, on the coefficients' device.

    Built once (host ``argsort`` of the rows): the terms in output order,
    each term's rank within its output's run, and the last term of every
    run.  :meth:`apply` gathers x, multiplies by the coefficients, folds
    each run with a log-step segmented scan of modular adds (⌈log2 k⌉ steps
    for at most k terms an output; step d adds only at the terms of rank
    ≥ d, the others being final), and writes each run's total to its
    output, one write per distinct output."""

    def __init__(self, rows, cols, coeffs: FrVec, out_len: int):
        rows = np.asarray(rows, dtype=np.int64)
        cols = np.asarray(cols, dtype=np.int64)
        if rows.shape != cols.shape or rows.shape[0] != len(coeffs):
            raise ValueError("rows, cols and coeffs must have one length")
        if rows.size and (rows.min() < 0 or rows.max() >= out_len):
            raise ValueError(f"output index outside [0, {out_len})")
        dev = coeffs.device
        self.out_len = out_len
        self.nnz = int(rows.size)
        # the native runtime's operands (a CPU plan), made at the first apply
        self._host = (rows, cols, coeffs.t) if dev.type == "cpu" else None
        self._host_words = None
        order = np.argsort(rows, kind="stable")
        r_sorted = rows[order]
        self.steps: list[tuple[int, torch.Tensor]] = []
        if self.nnz == 0:
            return
        starts = np.flatnonzero(np.r_[True, r_sorted[1:] != r_sorted[:-1]])
        ends = np.r_[starts[1:], self.nnz] - 1
        rank = np.arange(self.nnz) - np.repeat(starts, ends - starts + 1)
        order_t = torch.from_numpy(order).to(dev)
        self.gather = torch.from_numpy(cols[order]).to(dev)
        self.coeffs = coeffs.t.index_select(1, order_t)
        self.last = torch.from_numpy(ends).to(dev)
        self.out_pos = torch.from_numpy(r_sorted[ends]).to(dev)
        d = 1
        while d <= int(rank.max()):
            # the terms whose run holds the term d places before them
            self.steps.append((d, torch.from_numpy(np.flatnonzero(rank >= d)).to(dev)))
            d <<= 1

    def apply(self, x: FrVec) -> FrVec:
        return FrVec(self.apply_batch(x.t, 1))

    def _apply_native(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """The native sparse accumulate, once a vector (a CPU plan)."""
        if self._host_words is None:
            rows, cols, coeffs = self._host
            self._host_words = (rows.astype(np.uint32), cols.astype(np.uint32),
                                native.limbs_to_words(coeffs))
        rows, cols, coeffs = self._host_words
        words = native.limbs_to_words(x)
        in_len = x.shape[1] // batch
        out = [native.fr_spmv_arr(rows, cols, coeffs, words[b * in_len : (b + 1) * in_len],
                                  self.out_len) for b in range(batch)]
        return native.words_to_limbs(np.concatenate(out) if out else np.zeros((0, 4), "<u8"))

    def apply_batch(self, x: torch.Tensor, batch: int) -> torch.Tensor:
        """The plan on ``batch`` vectors laid end to end along the lane axis
        (x [16, batch·in_len] -> [16, batch·out_len]), in one pass: the
        gather, output and run indices are offset by each vector's start, so
        the terms of vector b stay in vector b's runs."""
        if x.shape[1] % batch:
            raise ValueError(f"{x.shape[1]} lanes are not {batch} vectors of one length")
        if self._host is not None and dvec.host_native(x):
            return self._apply_native(x, batch)
        out = dvec.zeros(batch * self.out_len, x.device)
        if self.nnz == 0:
            return out
        gather = _offset(self.gather, batch, x.shape[1] // batch)
        coeffs = self.coeffs if batch == 1 else self.coeffs.repeat(1, batch)
        s = dvec.mul(x.index_select(1, gather), coeffs)
        for d, active in self.steps:  # S_j += S_{j−d} within a run
            active = _offset(active, batch, self.nnz)
            s.index_copy_(1, active, dvec.add(s.index_select(1, active),
                                              s.index_select(1, active - d)))
        last = _offset(self.last, batch, self.nnz)
        out[:, _offset(self.out_pos, batch, self.out_len)] = s.index_select(1, last)  # distinct outputs
        return out

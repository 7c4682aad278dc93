"""Radix-2 evaluation domains over BLS12-377 Fr (2-adicity 47).

Port of ``simpleworks_tpu/poly/domain.py``.  The vector transforms take an
:class:`~simpleworks_tpu_torch.fields.frvec.FrVec` and run through
``dvec.fft``/``ifft``, so they follow the reference's ``_transform_vec``
off a TPU: the radix-2 butterfly NTT of
:mod:`simpleworks_tpu_torch.poly.ntt_device` on its device (the reference's
XLA butterfly), or the sharded 4-step NTT when :mod:`..ops.accel` routes a
transform there; a CPU vector's transform takes the native runtime's NTT
(the reference's native route).  :func:`ntt_host`, ``fft`` and ``ifft`` are the pure-Python oracle
(and the verifier's small transforms); the other list methods
(``coset_fft``, ``coset_ifft``, ``divide_by_vanishing``,
``lagrange_coeffs_at``) run the vector forms on ``device`` (the card by
default) and return ints.
"""

from __future__ import annotations

from ..device import resolve
from ..errors import ensure
from ..fields import dvec
from ..fields.bls12_377 import FR_MODULUS, fr_root_of_unity
from ..fields.frvec import FrVec

P = FR_MODULUS


def _bit_reverse_permute(values: list[int]) -> list[int]:
    n = len(values)
    bits = n.bit_length() - 1
    out = [0] * n
    for i, v in enumerate(values):
        j = int(bin(i)[2:].zfill(bits)[::-1], 2) if bits else 0
        out[j] = v
    return out


def ntt_host(values: list[int], omega: int) -> list[int]:
    """Iterative radix-2 Cooley-Tukey on Python ints; natural order in and
    out.  The oracle the device NTT is held against."""
    n = len(values)
    ensure(n > 0 and n & (n - 1) == 0, "NTT length must be a power of two")
    a = _bit_reverse_permute([v % P for v in values])
    length = 2
    while length <= n:
        w_len = pow(omega, n // length, P)
        half = length // 2
        for start in range(0, n, length):
            w = 1
            for j in range(start, start + half):
                u = a[j]
                t = a[j + half] * w % P
                a[j] = (u + t) % P
                a[j + half] = (u - t) % P
                w = w * w_len % P
        length <<= 1
    return a


def _trim(values: list[int]) -> list[int]:
    n = len(values)
    while n and values[n - 1] == 0:
        n -= 1
    return values[:n]


class Radix2Domain:
    """Multiplicative subgroup H = <g> of size 2^k with FFT/coset helpers."""

    def __init__(self, size: int):
        ensure(size >= 1 and size & (size - 1) == 0, "domain size must be a power of two")
        self.size = size
        self.group_gen = fr_root_of_unity(size) if size > 1 else 1
        self.group_gen_inv = pow(self.group_gen, P - 2, P)
        self.size_inv = pow(size, P - 2, P)
        self._elements: dict[str, FrVec] = {}

    @staticmethod
    def new_for(num_points: int) -> "Radix2Domain":
        size = 1
        while size < num_points:
            size <<= 1
        return Radix2Domain(size)

    def elements(self) -> list[int]:
        out, cur = [], 1
        for _ in range(self.size):
            out.append(cur)
            cur = cur * self.group_gen % P
        return out

    def element(self, i: int) -> int:
        return pow(self.group_gen, i, P)

    # -- list transforms (the oracle) -----------------------------------------

    def fft(self, coeffs: list[int]) -> list[int]:
        """coefficients -> evaluations over H (natural order)."""
        ensure(len(coeffs) <= self.size, "poly degree exceeds domain")
        return ntt_host(list(coeffs) + [0] * (self.size - len(coeffs)), self.group_gen)

    def ifft(self, evals: list[int]) -> list[int]:
        ensure(len(evals) == self.size, "evaluation count != domain size")
        return [c * self.size_inv % P for c in ntt_host(list(evals), self.group_gen_inv)]

    def coset_fft(self, coeffs: list[int], shift: int, device=None) -> list[int]:
        """Evaluations over the coset shift·H."""
        return self.coset_fft_vec(FrVec.from_ints(coeffs, device), shift).to_ints()

    def coset_ifft(self, evals: list[int], shift: int, device=None) -> list[int]:
        return self.coset_ifft_vec(FrVec.from_ints(evals, device), shift).to_ints()

    def divide_by_vanishing(self, coeffs: list[int], device=None) -> tuple[list[int], list[int]]:
        """(quotient, remainder) of division by X^n − 1, trailing zeros
        trimmed (below n coefficients: no quotient, the input as it is)."""
        if len(coeffs) < self.size:
            return [], list(coeffs)
        quot, rem = self.divide_by_vanishing_vec(FrVec.from_ints(coeffs, device))
        return _trim(quot.to_ints()), _trim(rem.to_ints())

    def lagrange_coeffs_at(self, point: int, device=None) -> list[int]:
        """L_i(point) for all i."""
        return self.lagrange_coeffs_vec(point, device).to_ints()

    # -- FrVec transforms (on the vector's device) ----------------------------

    def elements_vec(self, device=None) -> FrVec:
        """FrVec of [1, g, g², ..., g^(n−1)], built once per device."""
        dev = resolve(device)
        key = str(dev)
        if key not in self._elements:
            self._elements[key] = FrVec.powers(self.group_gen, self.size, dev)
        return self._elements[key]

    def fft_vec(self, v: FrVec) -> FrVec:
        """coefficients (length ≤ n) -> evaluations over H."""
        ensure(len(v) <= self.size, "poly degree exceeds domain")
        return FrVec(dvec.fft(v.t, self.size))

    def ifft_vec(self, v: FrVec) -> FrVec:
        ensure(len(v) == self.size, "evaluation count != domain size")
        return FrVec(dvec.ifft(v.t, self.size))

    def coset_fft_vec(self, v: FrVec, shift: int) -> FrVec:
        """Evaluations over the coset shift·H."""
        ensure(len(v) <= self.size, "poly degree exceeds domain")
        shifted = v.pad_to(self.size) * FrVec.powers(shift, self.size, v.device)
        return self.fft_vec(shifted)

    def coset_ifft_vec(self, v: FrVec, shift: int) -> FrVec:
        coeffs = self.ifft_vec(v)
        return coeffs * FrVec.powers(pow(shift, P - 2, P), self.size, v.device)

    def divide_by_vanishing_vec(self, v: FrVec) -> tuple[FrVec, FrVec]:
        """(quotient, remainder) of division by X^n − 1."""
        quot, rem = dvec.divide_by_vanishing(v.t, self.size)
        return FrVec(quot), FrVec(rem)

    def lagrange_coeffs_vec(self, point: int, device=None) -> FrVec:
        """FrVec of L_i(point) (barycentric)."""
        dev = resolve(device)
        v = self.evaluate_vanishing(point)
        elements = self.elements_vec(dev)
        if v == 0:
            out = dvec.zeros(self.size, dev)
            out[:, self.elements().index(point % P)] = FrVec.mont_scalar(1, dev)[:, 0]
            return FrVec(out)
        return (elements.rsub_scalar(point).inv() * elements).scale(v * self.size_inv % P)

    # -- vanishing polynomial v_H(X) = X^n − 1 --------------------------------

    def evaluate_vanishing(self, point: int) -> int:
        return (pow(point, self.size, P) - 1) % P

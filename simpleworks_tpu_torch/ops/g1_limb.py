"""Limb-major BLS12-377 G1 Jacobian arithmetic on the device.

Port of ``simpleworks_tpu/ops/g1_limb.py``: the compute path of the device
Pippenger MSM (:mod:`.msm_pippenger`) and of the SRS fixed-base powers
(:mod:`.srs_device`).  Coordinates are limb-major ``[24, B]`` ``torch.int32``
tensors of 16-bit Fq Montgomery limbs.

Complete branchless formulas: Z = 0 encodes the Jacobian identity, x = y = 0
the affine identity, and the equal-x cases resolve with selects.  The point
adds :func:`add` and :func:`madd` are one launch of a fused kernel on CUDA
tensors and its plain version on CPU tensors (:mod:`.g1_fused`; the port's
counterpart of the reference's ``SWTPU_FUSED_ADD=1``, with no switch and no
route back to the composed adds on the card).  Everything else
(:func:`double`, :func:`affine_madd`, the batch inversion) composes the
field kernels of :mod:`.mont_mul`; selects and zero tests are plain tensor
ops.  The composed adds stay as ``_add_composed`` and ``_madd_composed``, a
second witness for the fused kernels on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from ..curves.bls12_377 import G1Point
from ..device import resolve
from ..fields.bls12_377 import FQ_MODULUS
from ..fields.device import FQ, from_mont, to_mont
from . import g1_fused
from .g1_fused import fused_add, fused_madd, identity, one, select_point
from .mont_mul import mod_add, mod_sub, mont_mul, mont_pow

Q = FQ_MODULUS
L = FQ.n_limbs  # 24 16-bit limbs per Fq element

def inverse_base(device: torch.device) -> int:
    """Width at which batch_inverse stops halving and runs the Fermat kernel.
    On the card a lane is one thread, so any width that fits costs the same
    latency; on the CPU every lane of the plain version costs the same, so
    the tree goes deeper."""
    return 8192 if device.type == "cuda" else 64


class FqLimb(g1_fused.PlainFq):
    """Batched Fq ops on limb-major [24, B] Montgomery tensors through the
    field kernels (their plain versions on CPU tensors)."""

    def __init__(self, base: int | None = None):
        self.base = base  # None: inverse_base of the input's device

    @staticmethod
    def mul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mont_mul(a, b, FQ)

    @staticmethod
    def add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mod_add(a, b, FQ)

    @staticmethod
    def sub(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return mod_sub(a, b, FQ)

    def dbl(self, a: torch.Tensor) -> torch.Tensor:
        return self.add(a, a)

    @staticmethod
    def inv(x: torch.Tensor) -> torch.Tensor:
        """Elementwise Fermat inverse x^(q−2), one kernel (0 maps to 0)."""
        return mont_pow(x, Q - 2, FQ)

    def batch_inverse(self, x: torch.Tensor) -> torch.Tensor:
        """Elementwise inverses of a NONZERO [24, B] batch by Montgomery's
        trick on a halving product tree: ~3 muls a lane plus one Fermat
        kernel over at most ``inverse_base`` lanes (a zero lane would poison its
        subtree; callers mask degenerate lanes to one first).  The halves
        ``cur[:, :h]`` and ``cur[:, h:]`` are strided views, which the
        kernels read through their row stride without a copy."""
        B = x.shape[1]
        base = self.base or inverse_base(x.device)
        if B <= base:
            return self.inv(x)
        levels = []
        cur = x
        while cur.shape[1] > base:
            if cur.shape[1] % 2:
                cur = torch.cat([cur, FQ.one(1, x.device)], dim=1)
            h = cur.shape[1] // 2
            a, b = cur[:, :h], cur[:, h:]
            levels.append((a, b))
            cur = self.mul(a, b)
        inv = self.inv(cur)
        for a, b in reversed(levels):
            inv = inv[:, : a.shape[1]]  # drop the odd-width padding lane
            inv = torch.cat([self.mul(inv, b), self.mul(inv, a)], dim=1)
        return inv[:, :B]


_F = FqLimb()


# ------------------------------------------------------------- points ----


def double(p):
    """Jacobian doubling (dbl-2009-l, a = 0); Z = 0 in gives Z = 0 out."""
    return g1_fused.double_formula(p, _F)


def add(p, q):
    """Complete Jacobian addition of [24, B] coordinate triples: one fused
    kernel launch on CUDA tensors."""
    return fused_add(p, q)


def madd(p, q_affine):
    """Complete mixed addition: Jacobian ``p`` + affine ``q = (X2, Y2)``
    (madd-2007-bl, Z2 = 1; x = y = 0 encodes the affine identity): one fused
    kernel launch on CUDA tensors."""
    return fused_madd(p, q_affine)


def _add_composed(p, q):
    """:func:`add` composed of field-kernel launches."""
    return g1_fused.add_formula(p, q, _F)


def _madd_composed(p, q_affine):
    """:func:`madd` composed of field-kernel launches."""
    return g1_fused.madd_formula(p, q_affine, _F)


def affine_madd(acc, q_affine, valid):
    """Branchless complete affine + affine addition — the batch-affine MSM
    accumulate step.  ``acc``/``q_affine``: (X, Y) pairs of [24, B] limbs,
    x = y = 0 the identity; ``valid``: [B] lane mask (invalid lanes keep
    ``acc``).  One shared batched inversion replaces the per-lane division:

        λ  = (y2−y1)/(x2−x1)          (3x1²/(2y1) when doubling)
        x3 = λ² − x1 − x2
        y3 = λ(x1−x3) − y1

    Lanes whose result comes from a select invert 1 instead, so they never
    poison the inversion tree."""
    f = _F
    x1, y1 = acc
    x2, y2 = q_affine
    B = x1.shape[1]

    acc_inf = f.is_zero(x1) & f.is_zero(y1)
    q_inf = (f.is_zero(x2) & f.is_zero(y2)) | ~valid
    dx = f.sub(x2, x1)
    dy = f.sub(y2, y1)
    dbl = f.is_zero(dx) & f.is_zero(dy) & ~acc_inf & ~q_inf

    x1sq = f.mul(x1, x1)
    num = f.select(dbl, f.add(f.dbl(x1sq), x1sq), dy)  # 3x1² | y2−y1
    den = f.select(dbl, f.dbl(y1), dx)                 # 2y1  | x2−x1
    den_zero = f.is_zero(den)
    degenerate = acc_inf | q_inf | den_zero
    inv = f.batch_inverse(f.select(degenerate, one(B, x1.device), den))

    lam = f.mul(num, inv)
    x3 = f.sub(f.sub(f.mul(lam, lam), x1), x2)
    y3 = f.sub(f.mul(lam, f.sub(x1, x3)), y1)

    # identity out: P + (−P), or doubling a y = 0 point (den == 0 either way)
    iden_out = den_zero & ~acc_inf & ~q_inf
    zero = torch.zeros_like(x3)
    rx = f.select(iden_out, zero, x3)
    ry = f.select(iden_out, zero, y3)
    rx = f.select(acc_inf, x2, rx)
    ry = f.select(acc_inf, y2, ry)
    rx = f.select(q_inf, x1, rx)
    ry = f.select(q_inf, y1, ry)
    return rx, ry


def affine_to_jacobian(acc):
    """(X, Y) with x = y = 0 the identity -> Jacobian (X, Y, Z), Z = 0 the
    identity."""
    x, y = acc
    B = x.shape[1]
    is_id = _F.is_zero(x) & _F.is_zero(y)
    one, _, zero = identity(B, x.device)
    return (_F.select(is_id, one, x), _F.select(is_id, one, y), _F.select(is_id, zero, one))


def normalize_affine(xyz):
    """Jacobian ([24, N],)*3 -> [2, 24, N] affine X/Y planes (Z = 1, the
    identity as x = y = 0): one batched inversion of Z on the device."""
    X, Y, Z = xyz
    is_id = _F.is_zero(Z)
    zinv = _F.batch_inverse(_F.select(is_id, one(Z.shape[1], Z.device), Z))
    z2 = _F.mul(zinv, zinv)
    x = _F.mul(X, z2)
    y = _F.mul(_F.mul(Y, z2), zinv)
    zero = torch.zeros_like(x)
    return torch.stack([_F.select(is_id, zero, x), _F.select(is_id, zero, y)])


# -------------------------------------------------------- host bridge ----


def points_to_limb_major(points, device=None) -> tuple:
    """Host G1Points -> ([24, N],)*3 Montgomery tensors, Jacobian
    coordinates kept as they are."""
    return tuple(
        to_mont([(pt.X, pt.Y, pt.Z)[k] for pt in points], FQ, device) for k in range(3)
    )


def points_to_limb_major_affine(points, device=None) -> tuple:
    """Host G1Points -> ([24, N],)*3 tensors under the MSM's affine
    invariant (Z = 1; the identity packs as x = y = z = 0)."""
    norm = []
    for pt in points:
        if pt.is_identity():
            norm.append(G1Point(0, 0, 0))
        else:
            x, y = pt.to_affine()
            norm.append(G1Point(x, y, 1))
    return points_to_limb_major(norm, device)


def native_points_to_limb_major(points_native: np.ndarray, device=None) -> torch.Tensor:
    """[N, 18] u64 Jacobian Montgomery rows (the JAX package's SRS storage)
    -> one [2, 24, N] int32 tensor of the X/Y planes, a view and transpose
    with no bigints.  The rows must satisfy the affine invariant (Z = R mod q,
    identity rows all zero); a Jacobian table is refused, since the MSM's
    mixed adds read X and Y only."""
    rows = np.ascontiguousarray(points_native, dtype="<u8").reshape(-1, 18)
    r = FQ.r
    mont_one = np.array([(r >> (64 * t)) & 0xFFFFFFFFFFFFFFFF for t in range(6)], dtype="<u8")
    z_is_one = (rows[:, 12:18] == mont_one).all(axis=1)
    row_is_zero = (rows == 0).all(axis=1)
    if not bool((z_is_one | row_is_zero).all()):
        raise ValueError("point table violates the affine invariant (Z != 1): normalize it first")
    u16 = rows.view("<u2").reshape(-1, 3, L)
    coords = u16[:, :2].astype(np.int32).transpose(1, 2, 0)  # [2, 24, N]
    return torch.from_numpy(np.ascontiguousarray(coords)).to(resolve(device))


def points_from_limb_major(batch) -> list:
    """([24, N],)*3 Montgomery tensors -> host G1Points (fetches)."""
    xs, ys, zs = (from_mont(a, FQ) for a in batch)
    return [G1Point(x, y, z) for x, y, z in zip(xs, ys, zs)]


def points_from_affine_planes(xy: torch.Tensor) -> list:
    """[2, 24, N] affine planes -> host G1Points (x = y = 0 is the identity)."""
    xs, ys = from_mont(xy[0], FQ), from_mont(xy[1], FQ)
    return [G1Point.identity() if x == 0 and y == 0 else G1Point(x, y) for x, y in zip(xs, ys)]

"""Marlin AHP: the indexer and the verifier's sumcheck equations.

Port of ``simpleworks_tpu/marlin/ahp.py`` (ark-marlin's two-sumcheck R1CS
shape over the 12-polynomial index vocabulary row/col/val/row_col; see the
reference module for the protocol).  ``val`` stores val·col/n, the
u_H(col, col) = n/col normaliser folded in at indexing time.

The indexer runs on one device: the K-domain evaluations are gathers of the
H elements and Montgomery products, and the nine interpolations are device
NTTs.  The prover is :mod:`.prover`; the reference's host prover rounds
(``prover_round1..3``) are not ported, since the port has one prover.  The
verifier's equations are host ints.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..device import resolve
from ..errors import ensure
from ..fields import dvec
from ..fields.bls12_377 import FR_MODULUS
from ..fields.frvec import FrVec
from ..ops import mask_draw
from ..poly.dense import DensePoly
from ..poly.domain import Radix2Domain

P = FR_MODULUS


def next_pow2(x: int) -> int:
    n = 1
    while n < x:
        n <<= 1
    return n


@dataclass
class MatrixArithmetization:
    """Indexed polynomials of one R1CS matrix over domain K (row, col, val,
    row_col) and their evaluations on K."""

    row_poly: DensePoly       # K -> H elements
    col_poly: DensePoly
    val_poly: DensePoly       # val · col / n (the u_H diagonal normaliser)
    row_col_poly: DensePoly   # interpolates row·col on K
    row_evals: FrVec          # evaluations on K (prover-side)
    col_evals: FrVec
    val_evals: FrVec
    row_col_evals: FrVec


@dataclass
class IndexInfo:
    num_instance_padded: int  # ℓ (power of two)
    num_instance: int
    domain_h_size: int        # n
    domain_k_size: int        # m
    max_degree: int
    # ark-marlin's IndexInfo field set (the serde and Fiat-Shamir
    # vocabulary); n = next_pow2(max(nc, nv, 2)), m = next_pow2(max(nnz, 2))
    num_variables: int = 0    # ℓ + |witness| (the formatted column count)
    num_constraints: int = 0
    num_non_zero: int = 0


@dataclass
class Index:
    info: IndexInfo
    matrices: list[MatrixArithmetization]  # [A, B, C]


def index_from_polys(info: IndexInfo, polys: list[DensePoly]) -> Index:
    """The index of stored polynomials (row, col, val, row_col for A, then B,
    then C), on their device: the K-domain evaluations are recomputed, one
    NTT each."""
    ensure(len(polys) == 12, f"expected 12 index polynomials, got {len(polys)}")
    domain_k = Radix2Domain(info.domain_k_size)
    matrices = []
    for k in range(0, 12, 4):
        row, col, val, row_col = polys[k : k + 4]
        evals = [domain_k.fft_vec(poly.vec) for poly in (row, col, val, row_col)]
        matrices.append(MatrixArithmetization(row, col, val, row_col, *evals))
    return Index(info=info, matrices=matrices)


def max_degree_for(num_constraints: int, num_variables: int, num_non_zero: int) -> int:
    """SRS degree needed: max(3n − 1 outer incl. the zk mask, 3m − 3 inner)."""
    n = next_pow2(max(num_constraints, num_variables, 2))
    m = next_pow2(max(num_non_zero, 2))
    return max(3 * n - 1, 3 * m - 3)


def _map_columns(cols, num_instance: int, ell: int, n: int) -> np.ndarray:
    """R1CS columns -> H indices, ark-marlin's ``reindex_by_subdomain``
    stride layout: instance variable j at H index j·(n/ℓ) (the subgroup X),
    witness variable i in the non-X slots in order."""
    cols = np.asarray(cols, dtype=np.int64)
    ratio = n // ell
    if ratio == 1:
        # every H slot is an X slot: only possible with zero witnesses
        ensure(int((cols >= num_instance).sum()) == 0, "no witness slots when ℓ == n")
        return cols
    w = cols - num_instance  # witness ordinal (valid where cols >= num_instance)
    w_idx = (w // (ratio - 1)) * ratio + (w % (ratio - 1)) + 1
    return np.where(cols < num_instance, cols * ratio, w_idx)


def _ones(n: int, device) -> torch.Tensor:
    """[16, n] Montgomery ones (a writable copy)."""
    return dvec.const_vec(1, n, device).contiguous()


def index_matrices(cs, raw=None, device=None) -> Index:
    """Arithmetize the constraint system's A/B/C on ``device`` (the Marlin
    indexer core).  ``raw``: ``cs.to_matrices()`` when the caller has it."""
    dev = resolve(device)
    num_instance = cs.num_instance_variables
    ell = next_pow2(num_instance)
    num_cols_h = ell + cs.num_witness_variables
    n = next_pow2(max(cs.num_constraints, num_cols_h, 2))
    domain_h = Radix2Domain(n)
    if raw is None:
        raw = cs.to_matrices()
    m = next_pow2(max(max((len(r[0]) for r in raw), default=1), 2))
    domain_k = Radix2Domain(m)
    n_inv = pow(n, P - 2, P)
    h_elems = domain_h.elements_vec(dev).t

    matrices = []
    for rows, cols, coeffs in raw:
        nnz = len(rows)
        rows_t = torch.from_numpy(np.asarray(rows, dtype=np.int64)).to(dev)
        cols_t = torch.from_numpy(_map_columns(cols, num_instance, ell, n)).to(dev)
        # pad to m with val = 0, row = col = 1 (any H element keeps b(k) nonzero)
        row_evals = _ones(m, dev)
        col_evals = _ones(m, dev)
        row_evals[:, :nnz] = h_elems.index_select(1, rows_t)
        col_evals[:, :nnz] = h_elems.index_select(1, cols_t)
        vals = dvec.mul(dvec.from_ints(coeffs, dev), col_evals[:, :nnz])
        val_evals = dvec.pad_to(dvec.scale(vals, FrVec.mont_scalar(n_inv, dev)), m)
        row_col_evals = dvec.mul(row_evals, col_evals)
        evals = [FrVec(e) for e in (row_evals, col_evals, val_evals, row_col_evals)]
        polys = [DensePoly(domain_k.ifft_vec(e)) for e in evals]
        matrices.append(MatrixArithmetization(*polys, *evals))
    info = IndexInfo(
        num_instance_padded=ell,
        num_instance=num_instance,
        domain_h_size=n,
        domain_k_size=m,
        max_degree=max(3 * n - 1, 3 * m - 3),
        num_variables=num_cols_h,
        num_constraints=cs.num_constraints,
        num_non_zero=max((len(r[0]) for r in raw), default=1),
    )
    return Index(info=info, matrices=matrices)


def x_poly_from_instance(instance: list[int], ell: int, device=None) -> DensePoly:
    """Interpolate x̂ over the order-ℓ subgroup X (instance j at g_ℓ^j): one
    size-ℓ inverse NTT on ``device``."""
    values = FrVec.from_ints(list(instance), device).pad_to(ell)
    return DensePoly(Radix2Domain(ell).ifft_vec(values))


def x_poly_eval_host(instance: list[int], ell: int, point: int) -> int:
    """x̂(point) on the host (the verifier's side; ℓ is the instance size)."""
    coeffs = Radix2Domain(ell).ifft(list(instance) + [0] * (ell - len(instance)))
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * point + c) % P
    return acc


def sample_mask_poly(info: IndexInfo, rng, device) -> torch.Tensor:
    """[16, 3n] Montgomery limbs on ``device`` of a random s(X) of degree
    3n − 1 with Σ_{κ∈H} s(κ) = 0 (the outer-sumcheck zk mask; the
    reference's draws, ``Fr.rand_vec(rng, 3n)``, in its order).  Σ_H X^k = 0
    unless n | k, so the H-sum is n·Σ_j coeffs[j·n]; zero it by fixing
    coeffs[0].  Drawn where it is used (:mod:`..ops.mask_draw`)."""
    return mask_draw.draw_mask(rng, info.domain_h_size, device)


# ---------------------------------------------------------------- verifier ----


def verify_outer_sumcheck(
    info: IndexInfo,
    instance: list[int],
    alpha: int,
    etas: list[int],
    beta: int,
    evals: dict[str, int],
) -> bool:
    n = info.domain_h_size
    domain_h = Radix2Domain(n)
    v_h_alpha = domain_h.evaluate_vanishing(alpha)
    v_h_beta = domain_h.evaluate_vanishing(beta)
    u_ab = (v_h_alpha - v_h_beta) * pow((alpha - beta) % P, P - 2, P) % P
    # ℓ derived from the instance as given: a wrong input count makes x̂
    # inconsistent with the proof and the equation below rejects
    ell = next_pow2(max(len(instance), 1))
    v_x_beta = (pow(beta, ell, P) - 1) % P  # v_X = X^ℓ − 1
    z_beta = (evals["w"] * v_x_beta + x_poly_eval_host(instance, ell, beta)) % P
    eta_a, eta_b, eta_c = etas
    lhs = (
        evals.get("mask", 0)
        + u_ab
        * ((eta_a * evals["z_a"] + eta_b * evals["z_b"] + eta_c * evals["z_a"] % P * evals["z_b"]) % P)
        - evals["t"] * z_beta
    ) % P
    rhs = (evals["h_1"] * v_h_beta + beta * evals["g_1"]) % P
    return lhs == rhs


def verify_inner_sumcheck(
    info: IndexInfo,
    alpha: int,
    beta: int,
    etas: list[int],
    gamma: int,
    sigma_2: int,
    evals: dict[str, int],
) -> bool:
    n, m = info.domain_h_size, info.domain_k_size
    domain_h = Radix2Domain(n)
    domain_k = Radix2Domain(m)
    scale = domain_h.evaluate_vanishing(alpha) * domain_h.evaluate_vanishing(beta) % P
    names = ["a", "b", "c"]
    # b̂_M(γ) is linear in the opened evaluations (row_col is committed)
    b_vals = [
        (alpha * beta - alpha * evals[f"col_{nm}"] - beta * evals[f"row_{nm}"]
         + evals[f"row_col_{nm}"]) % P
        for nm in names
    ]
    a_gamma = 0
    for i, nm in enumerate(names):
        term = etas[i] * evals[f"val_{nm}"] % P * scale % P
        for j in range(3):
            if j != i:
                term = term * b_vals[j] % P
        a_gamma = (a_gamma + term) % P
    b_gamma = b_vals[0] * b_vals[1] % P * b_vals[2] % P
    f_gamma = (gamma * evals["g_2"] + sigma_2 * pow(m, P - 2, P)) % P
    lhs = (a_gamma - b_gamma * f_gamma) % P
    rhs = evals["h_2"] * domain_k.evaluate_vanishing(gamma) % P
    return lhs == rhs

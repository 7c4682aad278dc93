"""Marlin over KZG10 by its definition, with the trapdoor.

* The index: ark-marlin's arithmetization of the R1CS matrices A, B, C over
  the domain K (row, col, val, row_col a matrix; val carries col/n, the u_H
  normaliser), each index polynomial evaluated at tau by Lagrange
  interpolation over K, so its commitment is [f(tau)]G.
* The verifier: ark-marlin's transcript, both sumcheck equations and the
  batched KZG10 opening checks with degree bounds.  An opening check is
  e(L, H) == e(W, (tau - z)H); H generates G2 and the pairing is
  non-degenerate, so with tau known it holds exactly when L == (tau - z)W in
  G1, which is what this reference tests.

Points are Jacobian (X, Y, Z) tuples over Fq (:mod:`.g1`)."""

from __future__ import annotations

from dataclasses import dataclass

from . import g1
from .field import R, batch_inverse, next_pow2, root_of_unity
from .transcript import Transcript

PROTOCOL_NAME = b"MARLIN-2019"
BETA_POLYS = ["w", "z_a", "z_b", "mask", "t", "g_1", "h_1"]
INDEX_POLYS = [f"{kind}_{m}" for m in "abc" for kind in ("row", "col", "val", "row_col")]
GAMMA_POLYS = ["g_2", "h_2", *INDEX_POLYS]
EVALUATION_ORDER = sorted(BETA_POLYS + GAMMA_POLYS)


@dataclass
class Info:
    num_instance: int
    ell: int            # the instance domain's size (a power of two)
    n: int              # |H|
    m: int              # |K|
    num_variables: int  # ell + witnesses
    num_constraints: int
    num_non_zero: int   # the largest matrix's nonzero count


def max_degree_for(num_constraints: int, num_variables: int, num_non_zero: int) -> int:
    """The SRS degree a circuit of these sizes needs: max(3n - 1, 3m - 3)."""
    n = next_pow2(max(num_constraints, num_variables, 2))
    m = next_pow2(max(num_non_zero, 2))
    return max(3 * n - 1, 3 * m - 3)


def index_info(matrices, num_instance: int, num_witness: int, num_constraints: int) -> Info:
    ell = next_pow2(num_instance)
    num_variables = ell + num_witness
    n = next_pow2(max(num_constraints, num_variables, 2))
    nnz = max((len(rows) for rows, _, _ in matrices), default=1)
    m = next_pow2(max(nnz, 2))
    return Info(num_instance, ell, n, m, num_variables, num_constraints, nnz)


def _h_index(col: int, info: Info) -> int:
    """ark-marlin's reindex_by_subdomain: instance variable j at j * (n/ell),
    witness i in the slots outside that subgroup, in order."""
    ratio = info.n // info.ell
    if col < info.num_instance or ratio == 1:
        return col * ratio
    w = col - info.num_instance
    return (w // (ratio - 1)) * ratio + w % (ratio - 1) + 1


def lagrange_at(size: int, x: int) -> list[int]:
    """L_k(x) for k < size over the order-``size`` subgroup:
    w^k (x^size - 1) / (size (x - w^k))."""
    omega = root_of_unity(size)
    elems = [1] * size
    for k in range(1, size):
        elems[k] = elems[k - 1] * omega % R
    scale = (pow(x, size, R) - 1) * pow(size, -1, R) % R
    invs = batch_inverse([(x - e) % R for e in elems])
    return [e * inv % R * scale % R for e, inv in zip(elems, invs)]


def index_scalars(matrices, info: Info, tau: int) -> dict[str, int]:
    """f(tau) for each of the twelve index polynomials."""
    omega_h = root_of_unity(info.n)
    h_elems = [1] * info.n
    for i in range(1, info.n):
        h_elems[i] = h_elems[i - 1] * omega_h % R
    weights = lagrange_at(info.m, tau)
    n_inv = pow(info.n, -1, R)
    out = {}
    for name, (rows, cols, coeffs) in zip("abc", matrices):
        nnz = len(rows)
        row_e = [h_elems[r] for r in rows]
        col_e = [h_elems[_h_index(c, info)] for c in cols]
        val_e = [c % R * ce % R * n_inv % R for c, ce in zip(coeffs, col_e)]
        rc_e = [re * ce % R for re, ce in zip(row_e, col_e)]
        # entries past nnz: row = col = row_col = 1, val = 0
        pad = (sum(weights[nnz:]) % R) if nnz < info.m else 0
        for kind, evals in (("row", row_e), ("col", col_e), ("val", val_e), ("row_col", rc_e)):
            acc = sum(e * w for e, w in zip(evals, weights))
            if kind != "val":
                acc += pad
            out[f"{kind}_{name}"] = acc % R
    return out


def index_points(scalars: dict[str, int]) -> dict:
    return {name: g1.mul(s, g1.GENERATOR) for name, s in scalars.items()}


def _commitment_bytes(point, shifted=None, bounded: bool = False) -> bytes:
    out = g1.compress(point)
    if bounded:
        return out + b"\x01" + g1.compress(shifted)
    return out + b"\x00"


def transcript_bytes(info: Info, points: dict) -> bytes:
    meta = b"".join(v.to_bytes(8, "little")
                    for v in (info.num_variables, info.num_constraints, info.num_non_zero))
    return meta + b"".join(_commitment_bytes(points[name]) for name in INDEX_POLYS)


def _vanishing(size: int, x: int) -> int:
    return (pow(x, size, R) - 1) % R


def _instance_at(instance: list[int], x: int) -> int:
    ell = next_pow2(max(len(instance), 1))
    padded = list(instance) + [0] * (ell - len(instance))
    return sum(v * w for v, w in zip(padded, lagrange_at(ell, x))) % R


def outer_sumcheck(info: Info, instance, alpha, etas, beta, ev) -> bool:
    u_ab = (_vanishing(info.n, alpha) - _vanishing(info.n, beta)) \
        * pow((alpha - beta) % R, -1, R) % R
    ell = next_pow2(max(len(instance), 1))
    z_beta = (ev["w"] * ((pow(beta, ell, R) - 1) % R) + _instance_at(instance, beta)) % R
    eta_a, eta_b, eta_c = etas
    lhs = (ev["mask"] + u_ab * ((eta_a * ev["z_a"] + eta_b * ev["z_b"]
                                 + eta_c * ev["z_a"] % R * ev["z_b"]) % R)
           - ev["t"] * z_beta) % R
    return lhs == (ev["h_1"] * _vanishing(info.n, beta) + beta * ev["g_1"]) % R


def inner_sumcheck(info: Info, alpha, beta, etas, gamma, ev) -> bool:
    scale = _vanishing(info.n, alpha) * _vanishing(info.n, beta) % R
    b_vals = [(alpha * beta - alpha * ev[f"col_{m}"] - beta * ev[f"row_{m}"]
               + ev[f"row_col_{m}"]) % R for m in "abc"]
    a_gamma = 0
    for i, m in enumerate("abc"):
        term = etas[i] * ev[f"val_{m}"] % R * scale % R
        for j in range(3):
            if j != i:
                term = term * b_vals[j] % R
        a_gamma = (a_gamma + term) % R
    b_gamma = b_vals[0] * b_vals[1] % R * b_vals[2] % R
    f_gamma = (gamma * ev["g_2"] + ev["t"] * pow(info.m, -1, R)) % R
    return (a_gamma - b_gamma * f_gamma) % R == ev["h_2"] * _vanishing(info.m, gamma) % R


def opening_holds(batch, point: int, witness, xi: int, random_v: int, tau: int, gamma: int,
                  max_degree: int) -> bool:
    """The batched KZG10 check at ``point``: with weights 1, xi, xi^2, ...
    over each (commitment, shifted, value, bound) and its shifted twin,
    sum w C + sum w' (S - v [tau^(D-d)]G) - [sum w v]G - [r]gammaG must equal
    (tau - point) W."""
    lhs = g1.IDENTITY
    scalar = 0  # the multiple of G taken away
    weight = 1
    for comm, shifted, value, bound in batch:
        lhs = g1.add(lhs, g1.mul(weight, comm))
        scalar += weight * value
        weight = weight * xi % R
        if bound is not None:
            if shifted is None:
                return False
            lhs = g1.add(lhs, g1.mul(weight, shifted))
            scalar += weight * value % R * pow(tau, max_degree - bound, R)
            weight = weight * xi % R
    scalar = (scalar + random_v * gamma) % R
    lhs = g1.add(lhs, g1.neg(g1.mul(scalar, g1.GENERATOR)))
    return g1.equal(lhs, g1.mul((tau - point) % R, witness))


def verify(info: Info, points: dict, proof: dict, tau: int, gamma: int, max_degree: int,
           instance=(1,)) -> bool:
    """ark-marlin's verifier on ``proof``: {"commitments": {name: (C, S or
    None)}, "evaluations": {name: int}, "pc_proof_beta", "pc_proof_gamma":
    points, "pc_rand_beta", "pc_rand_gamma": ints}."""
    instance = [v % R for v in instance]
    comms = proof["commitments"]
    ev = proof["evaluations"]
    bounds = {"g_1": info.n - 2, "g_2": info.m - 2}
    try:
        def cbytes(name):
            point, shifted = comms[name]
            return _commitment_bytes(point, shifted, name in bounds)

        fs = Transcript(PROTOCOL_NAME + transcript_bytes(info, points)
                        + b"".join(v.to_bytes(32, "little") for v in instance))
        fs.absorb(b"".join(cbytes(n) for n in ("w", "z_a", "z_b", "mask")))
        alpha = fs.squeeze()
        etas = [fs.squeeze() for _ in range(3)]
        fs.absorb(b"".join(cbytes(n) for n in ("t", "g_1", "h_1")))
        beta = fs.squeeze()
        fs.absorb(b"".join(cbytes(n) for n in ("g_2", "h_2")))
        gamma_c = fs.squeeze()
        fs.absorb(b"".join((ev[n] % R).to_bytes(32, "little") for n in EVALUATION_ORDER))
        xi = fs.squeeze()
    except KeyError:
        return False
    if any(not 0 <= ev[n] < R for n in EVALUATION_ORDER):
        return False
    if not outer_sumcheck(info, instance, alpha, etas, beta, ev):
        return False
    if not inner_sumcheck(info, alpha, beta, etas, gamma_c, ev):
        return False
    all_comms = dict(comms)
    all_comms.update({name: (points[name], None) for name in INDEX_POLYS})
    for names, point, witness, random_v in (
        (BETA_POLYS, beta, proof["pc_proof_beta"], proof["pc_rand_beta"]),
        (GAMMA_POLYS, gamma_c, proof["pc_proof_gamma"], proof["pc_rand_gamma"]),
    ):
        batch = [(*all_comms[n], ev[n], bounds.get(n)) for n in names]
        if not opening_holds(batch, point, witness, xi, random_v, tau, gamma, max_degree):
            return False
    return True

"""The Marlin prover, on the device of the SRS.

Port of ``simpleworks_tpu/marlin/device_prover.py`` (``prove_device``), step
by step: the same Fiat-Shamir absorbs, the same RNG draws in the same order,
and the polynomial plane kept on the device from the witness upload through
the batch openings (``[16, N]`` Montgomery tensors of
:mod:`simpleworks_tpu_torch.fields.dvec`).  The host keeps Fiat-Shamir, the
RNG draws and the scalar fetches.  On CPU tensors the same code runs
through each kernel's plain version; its proof bytes equal the reference's
host ``marlin.prove``.

Departures from the reference's device prover, each a fault it has:

* the sparse r·v_H addends accumulate colliding positions (ℓ = n) instead
  of setting them (``_sparse_poly``);
* the sparse products are :class:`~simpleworks_tpu_torch.fields.frvec.SpmvPlan`
  sums, which accumulate every term of an output on the device;
* commits check the true degree (``kzg10.commit``), not the tensor width.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..errors import ensure
from ..fields import dvec
from ..fields.bls12_377 import FR_MODULUS, Fr
from ..fields.frvec import FrVec, SpmvPlan
from ..kzg import kzg10
from ..kzg.kzg10 import Commitment, Randomness
from ..poly.domain import Radix2Domain
from ..utils.observability import PROVER_TIMER
from . import ahp
from .fiat_shamir import FiatShamirRng

P = FR_MODULUS


def _mont(value: int, device) -> torch.Tensor:
    return FrVec.mont_scalar(value, device)


def _sparse_poly(width: int, entries: list[tuple[int, int]], device) -> torch.Tensor:
    """[16, width] tensor holding Σ of the (position, value) entries: values
    at one position add up (the r·v_H addends collide when ℓ = n)."""
    acc: dict[int, int] = {}
    for pos, v in entries:
        acc[pos] = (acc.get(pos, 0) + v) % P
    out = dvec.zeros(width, device)
    out[:, list(acc)] = dvec.from_ints(list(acc.values()), device)
    return out


@dataclass
class DeviceIndex:
    """What the prover keeps per proving key: the R1CS matrices it was built
    from, their sparse-product plans (terms sorted by output once), and the
    index tensors."""

    raw: list
    row_plans: list[SpmvPlan]   # out[row] += c·z[col_H]        (A, B)
    col_plans: list[SpmvPlan]   # out[col_H] += c·u[row]        (A, B, C)
    mats: list[dict[str, torch.Tensor]]


def _device_index(pk, raw) -> DeviceIndex:
    """The proving key's :class:`DeviceIndex`, rebuilt only when the
    constraint system's matrices differ from the cached ones."""
    cached = pk.device_index
    if cached is not None and cached.raw == raw:
        return cached
    info = pk.index.info
    n, ell, dev = info.domain_h_size, info.num_instance_padded, pk.srs.device
    row_plans, col_plans = [], []
    for k, (rows, cols, coeffs) in enumerate(raw):
        cols_h = ahp._map_columns(cols, info.num_instance, ell, n)
        coeffs_v = FrVec.from_ints(coeffs, dev)
        if k < 2:
            row_plans.append(SpmvPlan(rows, cols_h, coeffs_v, n))
        col_plans.append(SpmvPlan(cols_h, rows, coeffs_v, n))
    mats = [
        {"row_evals": mat.row_evals.t, "col_evals": mat.col_evals.t,
         "val_evals": mat.val_evals.t, "row": mat.row_poly.vec.t, "col": mat.col_poly.vec.t,
         "val": mat.val_poly.vec.t, "row_col": mat.row_col_poly.vec.t}
        for mat in pk.index.matrices
    ]
    pk.device_index = DeviceIndex(raw=raw, row_plans=row_plans, col_plans=col_plans, mats=mats)
    return pk.device_index


def _evaluate_many(polys: list[torch.Tensor], z: int) -> list[int]:
    """Several coefficient tensors at z: one shared powers table, one raw
    limb sum a polynomial, one host fetch for all."""
    if not polys:
        return []
    pw = dvec.powers_vec(z, max(int(p.shape[1]) for p in polys), polys[0].device)
    sums = torch.stack([dvec.sum_limbs_raw(dvec.mul(p, pw[:, : p.shape[1]])) for p in polys])
    raw = sums.cpu().numpy()
    return [dvec.limb_sums_to_int(raw[k]) for k in range(len(polys))]


def _nonzero(t: torch.Tensor) -> bool:
    return bool((t != 0).any())


def prove(pk, cs, rng):
    """Three-round zk AHP + batched hiding KZG openings on the SRS's device;
    returns the :class:`~simpleworks_tpu_torch.marlin.MarlinProof`."""
    from . import (BETA_POLYS, EVALUATION_ORDER, GAMMA_POLYS, PROTOCOL_NAME, MarlinProof,
                   _degree_bounds, _fixup_num_instance, _serialize_instance)

    idx, srs, info = pk.index, pk.srs, pk.index.info
    _fixup_num_instance(info, cs)
    dev = srs.device
    n, m = info.domain_h_size, info.domain_k_size
    ell = info.num_instance_padded
    domain_h = Radix2Domain(n)
    bounds = _degree_bounds(info)

    with PROVER_TIMER.region("host.to_matrices"):
        raw = cs.to_matrices()
    with PROVER_TIMER.region("host.device_index"):
        dix = _device_index(pk, raw)

    fs = FiatShamirRng(
        PROTOCOL_NAME + pk.vk.transcript_bytes() + _serialize_instance(cs.instance_assignment)
    )
    r_w, r_a, r_b = (Fr.rand(rng).value for _ in range(3))

    # ---------------------------------------------------------- round 1 ----
    with PROVER_TIMER.region("ahp.round1"):
        num_vars = info.num_instance + len(cs.witness_assignment)
        var_idx = ahp._map_columns(np.arange(num_vars, dtype=np.int64), info.num_instance, ell, n)
        z = dvec.zeros(n, dev)
        z[:, torch.from_numpy(var_idx).to(dev)] = dvec.from_ints(
            list(cs.instance_assignment) + list(cs.witness_assignment), dev)
        z_fr = FrVec(z)
        za_e, zb_e = (plan.apply(z_fr).t for plan in dix.row_plans)
        z_poly = dvec.ifft(z, n)
        z_a = dvec.ifft(za_e, n)
        z_b = dvec.ifft(zb_e, n)
        del z, z_fr, za_e, zb_e
        x_d = dvec.pad_to(ahp.x_poly_from_instance(cs.instance_assignment, ell, dev).vec.t, n)
        w, rem = dvec.divide_by_vanishing(dvec.sub(z_poly, x_d), ell)
        ensure(not _nonzero(rem), "ẑ − x̂ does not vanish on X (bad z layout?)")
        # zk randomization: +r·v_H (and ẑ += r_w·v_X·v_H)
        w = dvec.add(dvec.pad_to(w, n + 1), _sparse_poly(n + 1, [(0, P - r_w), (n, r_w)], dev))
        z_a = dvec.add(dvec.pad_to(z_a, n + 1), _sparse_poly(n + 1, [(0, P - r_a), (n, r_a)], dev))
        z_b = dvec.add(dvec.pad_to(z_b, n + 1), _sparse_poly(n + 1, [(0, P - r_b), (n, r_b)], dev))
        # (X^ℓ − 1)(X^n − 1)·r_w = r_w·(1 − X^ℓ − X^n + X^(n+ℓ))
        z_poly = dvec.add(dvec.pad_to(z_poly, n + ell + 1), _sparse_poly(
            n + ell + 1, [(0, r_w), (ell, P - r_w), (n, P - r_w), (n + ell, r_w)], dev))
    with PROVER_TIMER.region("host.mask_draws"):
        mask = ahp.sample_mask_poly(info, rng, dev)

    comms: dict[str, Commitment] = {}
    rands: dict[str, Randomness] = {}
    polys = {"w": w, "z_a": z_a, "z_b": z_b, "mask": mask}
    with PROVER_TIMER.region("kzg.commit.round1"):
        for name in ("w", "z_a", "z_b", "mask"):
            comms[name], rands[name] = kzg10.commit(srs, polys[name], hiding_rng=rng)
    fs.absorb(b"".join(comms[nm].serialize() for nm in ["w", "z_a", "z_b", "mask"]))
    alpha = fs.squeeze_field_element()
    etas = fs.squeeze_field_elements(3)

    # ---------------------------------------------------------- round 2 ----
    with PROVER_TIMER.region("ahp.round2"):
        v_h_alpha = domain_h.evaluate_vanishing(alpha)
        nq = 4 * n
        domain_q = Radix2Domain(nq)
        # 1/(α − h^i) on H and 1/(α − x) on the 4n domain: one inversion
        q_elems = dvec.powers_vec(domain_q.group_gen, nq, dev)
        inverses = dvec.inv(torch.cat([
            dvec.rsub_scalar(domain_h.elements_vec(dev).t, _mont(alpha, dev)),
            dvec.rsub_scalar(q_elems, _mont(alpha, dev)),
        ], dim=1))
        del q_elems
        u_alpha = FrVec(inverses[:, :n]).scale(v_h_alpha)  # u_H(α, h^i)
        t_evals = FrVec.zeros(n, dev)
        for eta, plan in zip(etas, dix.col_plans):
            t_evals = t_evals + plan.apply(u_alpha.scale(eta))
        t = dvec.ifft(t_evals.t, n)
        del u_alpha, t_evals

        za_q = dvec.fft(z_a, nq)
        zb_q = dvec.fft(z_b, nq)
        # u_H(α, X) on the 4n domain: (v_H(α) − (x^n − 1)) / (α − x)
        x_pow_n = dvec.powers_vec(pow(domain_q.group_gen, n, P), nq, dev)
        u_q = dvec.mul(dvec.rsub_scalar(x_pow_n, _mont((v_h_alpha + 1) % P, dev)),
                       inverses[:, n:])
        del inverses, x_pow_n
        eta_a, eta_b, eta_c = etas
        lin = dvec.add(
            dvec.mul(za_q, dvec.add(dvec.scale(zb_q, _mont(eta_c, dev)),
                                    dvec.const_vec(eta_a, nq, dev))),
            dvec.scale(zb_q, _mont(eta_b, dev)),
        )
        del za_q, zb_q
        q1_e = dvec.mul(u_q, lin)
        del u_q, lin
        q1_e = dvec.sub(q1_e, dvec.mul(dvec.fft(t, nq), dvec.fft(z_poly, nq)))
        q1_e = dvec.add(q1_e, dvec.fft(mask, nq))
        q1 = dvec.ifft(q1_e, nq)
        del q1_e
        h1, rem1 = dvec.divide_by_vanishing(q1, n)
        del q1
        rem1 = dvec.pad_to(rem1, n)
        ensure(not _nonzero(rem1[:, :1]), "outer sumcheck: non-zero H-sum (unsatisfied circuit?)")
        g_1 = rem1[:, 1:]
    polys.update(t=t, g_1=g_1, h_1=h1)
    with PROVER_TIMER.region("kzg.commit.round2"):
        comms["t"] = kzg10.commit(srs, t)
        comms["g_1"], rands["g_1"] = kzg10.commit(srs, g_1, degree_bound=bounds["g_1"],
                                                  hiding_rng=rng)
        comms["h_1"], rands["h_1"] = kzg10.commit(srs, h1, hiding_rng=rng)
    fs.absorb(b"".join(comms[nm].serialize() for nm in ["t", "g_1", "h_1"]))
    beta = fs.squeeze_field_element()

    # ---------------------------------------------------------- round 3 ----
    with PROVER_TIMER.region("ahp.round3"):
        v_h_beta = domain_h.evaluate_vanishing(beta)
        scale_ab = v_h_alpha * v_h_beta % P
        # b_M on K: (α − row_M)(β − col_M), the three inverted at once
        b_inv = dvec.inv(torch.cat([
            dvec.mul(dvec.rsub_scalar(mt["row_evals"], _mont(alpha, dev)),
                     dvec.rsub_scalar(mt["col_evals"], _mont(beta, dev)))
            for mt in dix.mats
        ], dim=1))
        f_evals = dvec.zeros(m, dev)
        for k, (eta, mt) in enumerate(zip(etas, dix.mats)):
            f_evals = dvec.add(f_evals, dvec.mul(dvec.scale(mt["val_evals"], _mont(eta, dev)),
                                                 b_inv[:, k * m : (k + 1) * m]))
        del b_inv
        f_evals = dvec.scale(f_evals, _mont(scale_ab, dev))
        sigma_2 = dvec.limb_sums_to_int(dvec.sum_limbs_raw(f_evals))
        f = dvec.ifft(f_evals, m)
        del f_evals
        ensure(dvec.scalar_to_int(f[:, :1]) == sigma_2 * pow(m, P - 2, P) % P,
               "inner sumcheck: f̂ constant term != σ₂/m")
        g_2 = f[:, 1:]

        ne = ahp.next_pow2(max(4 * m - 3, 2))
        b_e = []
        a_terms = []
        for mt in dix.mats:
            b_hat = dvec.sub(dvec.fft(mt["row_col"], ne),
                             dvec.scale(dvec.fft(mt["col"], ne), _mont(alpha, dev)))
            b_hat = dvec.sub(b_hat, dvec.scale(dvec.fft(mt["row"], ne), _mont(beta, dev)))
            b_e.append(dvec.add(b_hat, dvec.const_vec(alpha * beta % P, ne, dev)))
            del b_hat
        for k, (eta, mt) in enumerate(zip(etas, dix.mats)):
            others = [b_e[j] for j in range(3) if j != k]
            val_e = dvec.scale(dvec.fft(mt["val"], ne), _mont(eta * scale_ab % P, dev))
            a_terms.append(dvec.mul(val_e, dvec.mul(*others)))
            del val_e, others
        a_e = dvec.add(dvec.add(a_terms[0], a_terms[1]), a_terms[2])
        del a_terms
        bbb = dvec.mul(dvec.mul(b_e[0], b_e[1]), b_e[2])
        del b_e
        num_e = dvec.sub(a_e, dvec.mul(bbb, dvec.fft(f, ne)))
        del a_e, bbb
        numerator = dvec.ifft(num_e, ne)
        del num_e
        h2, rem2 = dvec.divide_by_vanishing(numerator, m)
        del numerator
        ensure(not _nonzero(rem2), "inner sumcheck: division remainder non-zero")
    polys.update(g_2=g_2, h_2=h2)
    with PROVER_TIMER.region("kzg.commit.round3"):
        comms["g_2"] = kzg10.commit(srs, g_2, degree_bound=bounds["g_2"])
        comms["h_2"] = kzg10.commit(srs, h2)
    fs.absorb(b"".join(comms[nm].serialize() for nm in ["g_2", "h_2"]))
    gamma = fs.squeeze_field_element()

    for mt, name in zip(dix.mats, ["a", "b", "c"]):
        for kind in ("row", "col", "val", "row_col"):
            polys[f"{kind}_{name}"] = mt[kind]

    evaluations: dict[str, int] = {}
    with PROVER_TIMER.region("evaluations"):
        for names, point in ((BETA_POLYS, beta), (GAMMA_POLYS, gamma)):
            evaluations.update(zip(names, _evaluate_many([polys[nm] for nm in names], point)))
    ensure(evaluations["t"] == sigma_2 % P, "inner sumcheck claim != opened t(β)")

    fs.absorb(b"".join(Fr(evaluations[nm]).serialize() for nm in EVALUATION_ORDER))
    xi = fs.squeeze_field_element()

    all_comms = dict(comms)
    all_comms.update(pk.vk.index_commitments)
    with PROVER_TIMER.region("kzg.batch_open"):
        openings = []
        for names, point in ((BETA_POLYS, beta), (GAMMA_POLYS, gamma)):
            batch = [(polys[nm], all_comms[nm], evaluations[nm], bounds[nm]) for nm in names]
            openings.append(kzg10.batch_open(srs, batch, point, xi,
                                             rands=[rands.get(nm) for nm in names]))
    (pc_beta, rand_beta), (pc_gamma, rand_gamma) = openings
    return MarlinProof(
        commitments=comms,
        evaluations=evaluations,
        pc_proof_beta=pc_beta,
        pc_proof_gamma=pc_gamma,
        pc_rand_beta=rand_beta,
        pc_rand_gamma=rand_gamma,
    )

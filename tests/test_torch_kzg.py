"""The port's KZG10 slice as a whole — setup → commit → batch_open →
batch_check — held against the JAX package's kzg10 from the same
``test_rng``: the same SRS points, the same commitment bytes, the same
opening witness and blinding evaluation."""

import os

import numpy as np
import pytest
import torch

from simpleworks_tpu import native
from simpleworks_tpu.kzg import kzg10 as ref_kzg
from simpleworks_tpu.ops import g1_limb as ref_g1
from simpleworks_tpu.poly.dense import DensePoly
from simpleworks_tpu.utils.rng import test_rng as ref_test_rng
from simpleworks_tpu_torch.errors import SimpleworksError
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.ops.msm_pippenger import msm_device_mont
from simpleworks_tpu_torch.utils.rng import test_rng

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers


@pytest.fixture(autouse=True, scope="module")
def _no_disk_checkpoints():
    """The disk checkpoints off: every setup and index of this file is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_SRS_DISK_CACHE", "0")
        mp.setenv("SWTPU_PK_DISK_CACHE", "0")
        yield


MAX_DEGREE = 1023
rng = np.random.default_rng(7)

#: (width, degree bound, hiding) of each polynomial of the batch opening
POLYS = {"plain": (20, None, False), "hiding": (24, None, True), "bounded": (18, 21, True)}


def rand_coeffs(n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


@pytest.fixture(scope="module")
def srs_pair():
    return ref_kzg.setup(MAX_DEGREE, ref_test_rng()), kzg10.setup(MAX_DEGREE, test_rng(), device=CPU)


@pytest.fixture(scope="module")
def opened(srs_pair):
    """Both packages commit to the same polynomials (the hiding ones from
    fresh, identical rngs) and open them at one point."""
    ref_srs, srs = srs_pair
    out = {"coeffs": {}, "ref": {}, "port": {}}
    for seed, (name, (width, bound, hiding)) in enumerate(POLYS.items()):
        coeffs = rand_coeffs(width)
        out["coeffs"][name] = coeffs
        if hiding:
            r_rng, p_rng = ref_test_rng(), test_rng()
            for _ in range(seed):  # distinct blinds per polynomial
                r_rng.next_u64(), p_rng.next_u64()
            out["ref"][name] = ref_kzg.commit(ref_srs, DensePoly(coeffs), bound, hiding_rng=r_rng)
            out["port"][name] = kzg10.commit(srs, dvec.from_ints(coeffs, CPU), bound,
                                             hiding_rng=p_rng)
        else:
            out["ref"][name] = (ref_kzg.commit(ref_srs, DensePoly(coeffs), bound), None)
            out["port"][name] = (kzg10.commit(srs, dvec.from_ints(coeffs, CPU), bound), None)
    point, xi = rand_coeffs(2)
    out["point"], out["xi"] = point, xi
    out["values"] = {name: DensePoly(c).evaluate(point) for name, c in out["coeffs"].items()}
    bounds = {name: spec[1] for name, spec in POLYS.items()}

    ref_labeled = [(DensePoly(out["coeffs"][k]), out["ref"][k][0], out["values"][k], bounds[k])
                   for k in POLYS]
    out["ref_open"] = ref_kzg.batch_open(ref_srs, ref_labeled, point, xi,
                                         rands=[out["ref"][k][1] for k in POLYS])
    labeled = [(dvec.from_ints(out["coeffs"][k], CPU), out["port"][k][0], out["values"][k],
                bounds[k]) for k in POLYS]
    out["port_open"] = kzg10.batch_open(srs, labeled, point, xi,
                                        rands=[out["port"][k][1] for k in POLYS])
    return out


def test_setup_matches_reference(srs_pair):
    ref_srs, srs = srs_pair
    assert srs.max_degree == ref_srs.max_degree == MAX_DEGREE
    ref_xy = np.asarray(ref_g1.native_points_to_limb_major(ref_srs.powers_native))
    assert torch.equal(srs.powers_xy, torch.from_numpy(ref_xy.astype(np.int32)))
    assert srs.h.serialize_compressed() == ref_srs.h.serialize_compressed()
    assert srs.beta_h.serialize_compressed() == ref_srs.beta_h.serialize_compressed()
    assert [g.serialize_compressed() for g in srs.powers_of_gamma_g] == \
        [g.serialize_compressed() for g in ref_srs.powers_of_gamma_g]
    for i in (0, 1, MAX_DEGREE):
        assert srs.power(i).serialize_compressed() == ref_srs.power(i).serialize_compressed()
    # the in-process memo hands back the same table for the same rng stream
    assert kzg10.setup(MAX_DEGREE, test_rng(), device=CPU) is srs


def test_srs_from_reference_round_trips(srs_pair):
    ref_srs, srs = srs_pair
    carried = kzg10.srs_from_reference(
        ref_srs.powers_native, ref_srs.h.serialize_compressed(),
        ref_srs.beta_h.serialize_compressed(),
        [g.serialize_compressed() for g in ref_srs.powers_of_gamma_g], device=CPU,
    )
    assert torch.equal(carried.powers_xy, srs.powers_xy)
    assert carried.h == srs.h and carried.beta_h == srs.beta_h
    assert carried.powers_of_gamma_g == srs.powers_of_gamma_g
    jacobian = ref_srs.powers_native.copy()
    jacobian[1, 12:18] = jacobian[1, :6]  # a row with Z != 1
    with pytest.raises(ValueError):
        kzg10.srs_from_reference(jacobian, b"", b"", [], device=CPU)


@pytest.mark.parametrize("name", list(POLYS))
def test_commit_matches_reference(opened, name):
    ref_comm, ref_rand = opened["ref"][name]
    comm, rand = opened["port"][name]
    assert comm.serialize() == ref_comm.serialize()
    assert comm.degree_bound == ref_comm.degree_bound
    if ref_rand is not None:
        assert rand.blind == ref_rand.blind.coeffs
        if ref_rand.shifted_blind is not None:
            assert rand.shifted_blind == ref_rand.shifted_blind.coeffs


def test_batch_open_matches_reference(opened):
    (ref_w, ref_v), (w, v) = opened["ref_open"], opened["port_open"]
    assert w.serialize_compressed() == ref_w.serialize_compressed()
    assert v == ref_v and v != 0


def _check(srs, opened, values, check=kzg10.batch_check):
    bounds = {name: spec[1] for name, spec in POLYS.items()}
    labeled = [(None, opened["port"][k][0], values[k], bounds[k]) for k in POLYS]
    shift_powers = {b: srs.power(srs.max_degree - b) for b in bounds.values() if b is not None}
    w, random_v = opened["port_open"]
    return check(srs.first_power(), srs.h, srs.beta_h, srs.max_degree, labeled, opened["point"],
                 w, opened["xi"], gamma_g=srs.gamma_g, random_v=random_v,
                 shift_powers=shift_powers)


def test_batch_check_accepts_and_rejects(srs_pair, opened):
    ref_srs, srs = srs_pair
    assert _check(srs, opened, opened["values"])
    tampered = dict(opened["values"], hiding=(opened["values"]["hiding"] + 1) % P)
    assert not _check(srs, opened, tampered)
    # the reference's verifier accepts the port's proof
    assert _check(ref_srs, opened, opened["values"], check=ref_kzg.batch_check)


def test_commit_checks_true_degree(srs_pair):
    ref_srs, srs = srs_pair
    coeffs = rand_coeffs(16)
    wide = dvec.pad_to(dvec.from_ints(coeffs, CPU), MAX_DEGREE + 9)  # zero tail past the SRS
    assert kzg10.commit(srs, wide).serialize() == \
        ref_kzg.commit(ref_srs, DensePoly(coeffs)).serialize()
    too_long = dvec.from_ints([0] * (MAX_DEGREE + 1) + [1], CPU)
    with pytest.raises(SimpleworksError):
        kzg10.commit(srs, too_long)
    with pytest.raises(SimpleworksError):
        kzg10.commit(srs, wide, degree_bound=14)
    assert kzg10.commit(srs, dvec.zeros(5, CPU)).comm.is_identity()


def test_commit_through_the_tensor_msm(srs_pair, opened):
    """CPU tensors take the host MSM in ``commit``; the tensor MSM (the
    card's route, run here through the plain versions) gives the same
    commitment and shifted commitment."""
    _, srs = srs_pair
    coeffs = dvec.from_ints(opened["coeffs"]["bounded"], CPU)
    bound = POLYS["bounded"][1]
    comm = kzg10.commit(srs, coeffs, bound)
    assert comm.comm == msm_device_mont(srs.powers_xy, coeffs)
    assert comm.shifted_comm == msm_device_mont(srs.powers_xy, coeffs,
                                                offset=srs.max_degree - bound)

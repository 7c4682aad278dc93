"""The port's parallel planes held against the JAX package's, on the CPU, over
lists of CPU devices standing in for the reference's 8 virtual devices:
batched R1CS checks, the sharded witness check, the sharded 4-step NTT, the
sharded MSM, and a proof's bytes with the prover's transforms and commits
routed over eight shards.  Tolerance 0: equal integers, group elements and
bytes."""

import copy

import numpy as np
import pytest
import torch

from simpleworks_tpu import marlin as ref_marlin
from simpleworks_tpu.examples import manual_constraints as ref_manual
from simpleworks_tpu.examples import test_circuit as ref_test_circuit
from simpleworks_tpu.fields.bls12_377 import ConstraintF as RefF
from simpleworks_tpu.fields.frvec import FrVec as RefFrVec
from simpleworks_tpu.kzg import kzg10 as ref_kzg
from simpleworks_tpu.kzg.msm import msm as ref_msm
from simpleworks_tpu.marlin import serialization as ref_serde
from simpleworks_tpu.poly.domain import Radix2Domain as RefDomain
from simpleworks_tpu.r1cs.constraint_system import ONE as REF_ONE
from simpleworks_tpu.r1cs.constraint_system import ConstraintSystem as RefCS
from simpleworks_tpu.utils.rng import test_rng as ref_test_rng
from simpleworks_tpu_torch import marlin
from simpleworks_tpu_torch.examples import manual_constraints, test_circuit
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
from simpleworks_tpu_torch.fields.frvec import FrVec
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.marlin import serialization as serde
from simpleworks_tpu_torch.ops import accel, g1_limb
from simpleworks_tpu_torch.ops.msm_pippenger import msm_device_mont
from simpleworks_tpu_torch.parallel import default_devices, msm_sharded, ntt_sharded
from simpleworks_tpu_torch.parallel.witness_dp import make_sharded_checker, sharded_check_host
from simpleworks_tpu_torch.r1cs.constraint_system import ONE, ConstraintSystem
from simpleworks_tpu_torch.r1cs.satisfiability import DeviceR1CS

torch.set_num_threads(1)  # more threads only contend with the other test workers

CPU = torch.device("cpu")
CPU8 = ["cpu"] * 8
#: tests/test_parallel.py::test_sharded_witness_dp's rows of the manual
#: circuit, z = [1, input, witness], and their verdicts
ROWS = [[1, 3, 3], [1, 3, 4], [1, 9, 9], [1, 2, 3], [1, 0, 0], [1, 5, 5], [1, 5, 6], [1, 7, 7]]
VERDICTS = [True, False, True, False, True, True, False, True]


def reference_verdicts(ref_cs, rows) -> list[bool]:
    """The JAX package's ``ConstraintSystem.is_satisfied`` of each row put in
    ``ref_cs``'s place (its XLA ``DeviceR1CS`` takes ~10 s a circuit to
    compile here)."""
    n_inst = ref_cs.num_instance_variables
    out = []
    for row in rows:
        cs = copy.copy(ref_cs)
        cs.instance_assignment, cs.witness_assignment = list(row[:n_inst]), list(row[n_inst:])
        out.append(cs.is_satisfied())
    return out


def seeded_values(n: int, seed: int) -> list[int]:
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(40), "little") % P for _ in range(n)]


CIRCUITS = {
    "manual": (lambda: manual_constraints.synthesize(3, 3), lambda: ref_manual.synthesize(3, 3),
               ROWS),
    "gadget": (lambda: test_circuit.synthesize(42, 42), lambda: ref_test_circuit.synthesize(42, 42),
               None),
    "gadget_unsatisfied": (lambda: test_circuit.synthesize(41, 42),
                           lambda: ref_test_circuit.synthesize(41, 42), None),
}


@pytest.mark.parametrize("name", list(CIRCUITS))
def test_device_r1cs_matches_reference(name):
    build, ref_build, rows = CIRCUITS[name]
    cs, ref_cs = build(), ref_build()
    rows = rows or [cs.full_assignment()]
    got = DeviceR1CS(cs, CPU).check(rows)
    assert got.dtype == torch.bool and got.device == CPU
    assert got.tolist() == reference_verdicts(ref_cs, rows)
    if name == "manual":
        assert got.tolist() == VERDICTS
    else:
        assert got.tolist() == [name == "gadget"]


def test_device_r1cs_rejects_a_short_row():
    with pytest.raises(ValueError, match="3 columns"):
        DeviceR1CS(manual_constraints.synthesize(3, 3), CPU).check([[1, 3]])


@pytest.mark.parametrize("shards", [1, 3, 8])
def test_sharded_check_host_matches_reference(shards):
    """3 shards pad the 8 rows to 9 with the circuit's own assignment."""
    cs = manual_constraints.synthesize(3, 3)
    assert sharded_check_host(["cpu"] * shards, cs, ROWS) == VERDICTS
    assert sharded_check_host(["cpu"] * shards, cs, []) == []
    if shards == 8:
        ok, failures = make_sharded_checker(CPU8, cs)(ROWS)
        assert ok.tolist() == VERDICTS and failures == VERDICTS.count(False)


def test_default_devices_names_the_cpu():
    assert default_devices("cpu") == [CPU]
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            default_devices()


@pytest.mark.parametrize("n", [256, 1024])
def test_sharded_ntt_matches_reference(n):
    values = seeded_values(n, n)
    x = dvec.from_ints(values, CPU)
    got = ntt_sharded.sharded_transform_vec(CPU8, FrVec(x))
    assert torch.equal(got.t, dvec.fft(x, n))
    assert got.to_ints() == RefDomain(n).fft_vec(RefFrVec.from_ints(values)).to_ints()
    back = ntt_sharded.sharded_transform_vec(CPU8, got, inverse=True)
    assert torch.equal(back.t, x)  # the round trip, 1/n included
    assert torch.equal(back.t, dvec.ifft(got.t, n))
    if n == 256:
        assert ntt_sharded.sharded_ntt_host(CPU8, values) == RefDomain(n).fft(values)


@pytest.mark.parametrize("shards, n, supported", [
    (8, 256, True), (8, 128, True), (8, 32, False), (3, 256, False), (1, 4, True),
    (8, 6, False), (8, 2, False),
])
def test_sharded_transform_supported(shards, n, supported):
    assert ntt_sharded.sharded_transform_supported(["cpu"] * shards, n) is supported
    if not supported and n >= 4 and n & (n - 1) == 0:
        with pytest.raises(ValueError, match="does not split"):
            ntt_sharded.sharded_transform(["cpu"] * shards, dvec.zeros(n, CPU))


@pytest.fixture(scope="module")
def srs_pair():
    """SRS(128, 128, 128) of both packages on one state (the JAX package's
    setup, carried over)."""
    ref_srs = ref_marlin.universal_setup(128, 128, 128, ref_marlin.generate_rand())
    srs = kzg10.srs_from_reference(
        ref_srs.powers_native, ref_srs.h.serialize_compressed(),
        ref_srs.beta_h.serialize_compressed(),
        [g.serialize_compressed() for g in ref_srs.powers_of_gamma_g], device=CPU)
    return ref_srs, srs


@pytest.fixture(scope="module")
def msm_points():
    """1,100 powers of a JAX-package SRS: its point list and the same points
    as the port's affine planes."""
    ref_srs = ref_kzg.setup(1100, ref_test_rng())
    return ref_srs.powers_of_g, g1_limb.native_points_to_limb_major(ref_srs.powers_native, CPU)


@pytest.mark.parametrize("n, shards, host_width", [(13, 8, None), (13, 2, 0), (1 << 10, 8, None)],
                         ids=["13", "13-tensor-shards", "1024"])
def test_sharded_msm_matches_reference(msm_points, monkeypatch, n, shards, host_width):
    """CPU shards (at 13 points over 8, the last ones short or empty) against
    the unsharded device MSM and the JAX package's Pippenger, as group
    elements.  A CPU shard takes the host Pippenger up to
    ``HOST_MSM_MAX_WIDTH`` coefficients, as an unsharded commit does, so one
    case sets it to 0: every shard then runs ``msm_device_mont``, the route
    of every shard on the card."""
    ref_points, planes = msm_points
    offset = 7
    scalars = seeded_values(n, 100 + n)
    coeffs = dvec.from_ints(scalars, CPU)
    expected = ref_msm(ref_points[offset : offset + n], scalars).serialize_compressed()
    if host_width is not None:
        monkeypatch.setattr(kzg10, "HOST_MSM_MAX_WIDTH", host_width)
    devices = ["cpu"] * shards
    got = msm_sharded.sharded_msm(devices, planes, coeffs, offset=offset)
    assert got.serialize_compressed() == expected
    assert got == msm_device_mont(planes, coeffs, offset=offset)
    if host_width is None:
        points = g1_limb.points_from_affine_planes(planes[:, :, offset : offset + n])
        assert msm_sharded.sharded_msm_host(devices, points, scalars) == got


def square_chain(cs_cls, one, field, n_constraints: int, x: int = 3):
    """tests/test_parallel.py::_square_chain_cs: x public, w_0 = x,
    w_{i+1} = w_i²."""
    cs = cs_cls(field)
    a = cs.new_input_variable(x)
    cur_val = x
    cur = cs.new_witness_variable(cur_val)
    cs.enforce_constraint(cs.lc((1, a)) - cs.lc((1, cur)), cs.lc((1, one)), cs.lc())
    for _ in range(n_constraints):
        nxt_val = cur_val * cur_val % P
        nxt = cs.new_witness_variable(nxt_val)
        cs.enforce_constraint(cs.lc((1, cur)), cs.lc((1, cur)), cs.lc((1, nxt)))
        cur, cur_val = nxt, nxt_val
    return cs


def test_prove_bytes_one_vs_eight_shards(srs_pair, monkeypatch):
    """tests/test_parallel.py::test_prove_bytes_1_vs_8 on the port: the
    prover's transforms and commits routed over eight CPU shards through
    ``ops.accel`` give the bytes of the unsharded prove and of the JAX host
    prover; both sharded routes are counted, so the case cannot pass by
    never taking them."""
    ref_srs, srs = srs_pair
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_DEVICE_PROVER", "0")
        mp.setenv("SWTPU_PK_DISK_CACHE", "0")
        ref_cs = square_chain(RefCS, REF_ONE, RefF, 120)
        ref_pk, _ = ref_marlin.index(ref_srs, ref_cs)
        ref_bytes = ref_serde.serialize_proof(ref_marlin.prove(ref_pk, ref_cs))
    cs = square_chain(ConstraintSystem, ONE, ConstraintF, 120)
    pk, vk = marlin.index(srs, cs)
    plain_bytes = serde.serialize_proof(marlin.prove(pk, cs))

    calls = {"ntt": 0, "msm": 0}
    transform, msm = ntt_sharded.sharded_transform, msm_sharded.sharded_msm

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            calls[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    monkeypatch.setattr(ntt_sharded, "sharded_transform", counted("ntt", transform))
    monkeypatch.setattr(msm_sharded, "sharded_msm", counted("msm", msm))
    monkeypatch.setattr(accel, "SHARDED_NTT_THRESHOLD", 128)
    monkeypatch.setattr(accel, "SHARDED_MSM_THRESHOLD", 64)
    accel.set_prover_devices(CPU8)
    try:
        proof = marlin.prove(pk, cs)
    finally:
        accel.set_prover_devices(None)
    assert calls["ntt"] > 0 and calls["msm"] > 0, calls
    assert serde.serialize_proof(proof) == plain_bytes == ref_bytes
    assert marlin.verify(vk, [3], proof)
    assert accel.prover_devices() is None and not accel.use_sharded_ntt(1 << 20)

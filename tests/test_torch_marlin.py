"""The port's Marlin slice as a whole — index → prove → verify — held against
the JAX package's host prover on the CPU: equal verifying-key bytes, equal
proof bytes from the same rng, each package accepting the other's proofs
after serde, tampered proofs rejected.  Both packages prove over one SRS
(the reference's, carried over with ``srs_from_reference``)."""

import dataclasses
import os

import pytest
import torch

from simpleworks_tpu import marlin as ref_marlin
from simpleworks_tpu.examples import manual_constraints as ref_manual
from simpleworks_tpu.fields.bls12_377 import ConstraintF as RefF
from simpleworks_tpu.marlin import serialization as ref_serde
from simpleworks_tpu.marlin.fiat_shamir import FiatShamirRng as RefFiatShamirRng
from simpleworks_tpu.r1cs.constraint_system import ONE as REF_ONE
from simpleworks_tpu.r1cs.constraint_system import ConstraintSystem as RefCS
from simpleworks_tpu_torch import marlin
from simpleworks_tpu_torch.device import resolve
from simpleworks_tpu_torch.examples import manual_constraints
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
from simpleworks_tpu_torch.fields.device import mont_scalar
from simpleworks_tpu_torch.fields.frvec import FrVec
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.marlin import serialization as serde
from simpleworks_tpu_torch.marlin.fiat_shamir import FiatShamirRng
from simpleworks_tpu_torch.ops import g1_limb
from simpleworks_tpu_torch.r1cs.constraint_system import ONE, ConstraintSystem

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


#: SRS(16, 16, 32): degree 93, enough for every circuit below (the chain of
#: 5 needs 45)
SRS_SIZES = (16, 16, 32)


def square_add_chain(cs_cls, one, field, steps: int, x: int = 3):
    """x_0 = x (public), x_{i+1} = x_i² + x_i: n = 8, m = 16 for 5 steps."""
    cs = cs_cls(field)
    a = cs.new_input_variable(x)
    cur_val = x
    cur = cs.new_witness_variable(cur_val)
    cs.enforce_constraint(cs.lc((1, a)) - cs.lc((1, cur)), cs.lc((1, one)), cs.lc())
    for _ in range(steps):
        nxt_val = (cur_val * cur_val + cur_val) % P
        nxt = cs.new_witness_variable(nxt_val)
        cs.enforce_constraint(cs.lc((1, cur)), cs.lc((1, cur)), cs.lc((1, nxt)) - cs.lc((1, cur)))
        cur, cur_val = nxt, nxt_val
    return cs


def instance_only(cs_cls, one, field, x: int = 5):
    """One public input and no witness: ℓ = n = 2, where the r·v_H addends
    of ẑ collide (the reference's device prover sets instead of adding)."""
    cs = cs_cls(field)
    a = cs.new_input_variable(x)
    cs.enforce_constraint(cs.lc((1, a)), cs.lc((1, one)), cs.lc((1, a)))
    return cs


CIRCUITS = {
    "manual": (lambda: manual_constraints.synthesize(3, 3),
               lambda: ref_manual.synthesize(3, 3), [3]),
    "chain": (lambda: square_add_chain(ConstraintSystem, ONE, ConstraintF, 5),
              lambda: square_add_chain(RefCS, REF_ONE, RefF, 5), [3]),
    "ell_eq_n": (lambda: instance_only(ConstraintSystem, ONE, ConstraintF),
                 lambda: instance_only(RefCS, REF_ONE, RefF), [5]),
}
#: the chain again, indexed and proved with the native runtime off: the
#: plain versions carry the whole prove
CIRCUITS["chain_native_off"] = CIRCUITS["chain"]


@pytest.fixture(scope="module")
def srs_pair():
    ref_srs = ref_marlin.universal_setup(*SRS_SIZES, ref_marlin.generate_rand())
    srs = kzg10.srs_from_reference(
        ref_srs.powers_native, ref_srs.h.serialize_compressed(),
        ref_srs.beta_h.serialize_compressed(),
        [g.serialize_compressed() for g in ref_srs.powers_of_gamma_g], device=CPU)
    return ref_srs, srs


@pytest.fixture(scope="module", params=list(CIRCUITS))
def proved(request, srs_pair):
    """Both packages index and prove one circuit; the reference through its
    host prover (the device twin off, no disk checkpoint)."""
    ref_srs, srs = srs_pair
    build, ref_build, public = CIRCUITS[request.param]
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_DEVICE_PROVER", "0")
        mp.setenv("SWTPU_PK_DISK_CACHE", "0")
        ref_cs = ref_build()
        ref_pk, ref_vk = ref_marlin.index(ref_srs, ref_cs)
        ref_proof = ref_marlin.prove(ref_pk, ref_cs)
    cs = build()
    with pytest.MonkeyPatch.context() as mp:
        if request.param.endswith("_native_off"):
            mp.setenv("SWTPU_NATIVE", "0")
            marlin._INDEX_MEMO.clear()  # index anew, on the plain versions
        pk, vk = marlin.index(srs, cs)
        proof = marlin.prove(pk, cs)
    return {"public": public, "cs": cs, "pk": pk, "vk": vk, "proof": proof,
            "ref_vk": ref_vk, "ref_proof": ref_proof}


def test_fiat_shamir_stream_matches_reference():
    fs, ref = FiatShamirRng(b"marlin"), RefFiatShamirRng(b"marlin")
    assert fs.squeeze_field_elements(3) == ref.squeeze_field_elements(3)
    fs.absorb(b"commitments")
    ref.absorb(b"commitments")
    assert fs.squeeze_field_element() == ref.squeeze_field_element()
    assert fs.rng.next_u64() == ref.rng.next_u64()


def test_index_matches_reference(proved):
    assert serde.serialize_verifying_key(proved["vk"]) == \
        ref_serde.serialize_verifying_key(proved["ref_vk"])
    vk = serde.deserialize_verifying_key(serde.serialize_verifying_key(proved["vk"]))
    assert serde.serialize_verifying_key(vk) == serde.serialize_verifying_key(proved["vk"])
    assert marlin.index(proved["pk"].srs, proved["cs"])[1] is proved["vk"]  # the memo


def test_proof_bytes_match_reference_host_prover(proved):
    assert serde.serialize_proof(proved["proof"]) == ref_serde.serialize_proof(proved["ref_proof"])


def test_each_package_verifies_the_others_proof(proved):
    public = proved["public"]
    port_bytes = serde.serialize_proof(proved["proof"])
    ref_bytes = ref_serde.serialize_proof(proved["ref_proof"])
    assert marlin.verify(proved["vk"], public, serde.deserialize_proof(ref_bytes))
    assert ref_marlin.verify(proved["ref_vk"], public, ref_serde.deserialize_proof(port_bytes))
    assert serde.serialize_proof(serde.deserialize_proof(port_bytes)) == port_bytes


def test_tampered_proofs_are_rejected(proved):
    proof, vk, public = proved["proof"], proved["vk"], proved["public"]
    evals = dict(proof.evaluations, t=(proof.evaluations["t"] + 1) % P)
    assert not marlin.verify(vk, public, dataclasses.replace(proof, evaluations=evals))
    assert not marlin.verify(vk, [public[0] + 1], proof)
    comms = dict(proof.commitments)
    del comms["g_2"]
    assert not marlin.verify(vk, public, dataclasses.replace(proof, commitments=comms))


def test_prove_refuses_an_unsatisfied_circuit(srs_pair):
    _, srs = srs_pair
    cs = manual_constraints.synthesize(3, 4)
    pk, _ = marlin.index(srs, cs)
    with pytest.raises(ValueError):
        marlin.prove(pk, cs)


def test_universal_setup_matches_reference():
    ref_srs = ref_marlin.universal_setup(2, 2, 2, ref_marlin.generate_rand())
    srs = marlin.universal_setup(2, 2, 2, marlin.generate_rand(), device=CPU)
    assert srs.max_degree == ref_srs.max_degree == 5
    assert [srs.power(i).serialize_compressed() for i in range(6)] == \
        [ref_srs.power(i).serialize_compressed() for i in range(6)]


def test_entry_points_run_on_the_card_by_default():
    """Without a device argument every entry point lands on CUDA, or raises
    where PyTorch sees no card; none falls back to the CPU."""
    calls = [
        lambda: mont_scalar(7),
        lambda: dvec.from_ints([1, 2]),
        lambda: dvec.zeros(3),
        lambda: FrVec.from_ints([1]).t,
        lambda: g1_limb.points_to_limb_major([kzg10.G1Point.generator()])[0],
        lambda: marlin.universal_setup(2, 2, 2, marlin.generate_rand()).powers_xy,
    ]
    assert resolve("cpu") == resolve(CPU) == CPU  # the CPU only when asked for
    for call in calls:
        if torch.cuda.is_available():
            assert call().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                call()

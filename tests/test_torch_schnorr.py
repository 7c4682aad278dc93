"""The port's circuit stack up to the bench circuit, held against the JAX
package: native Schnorr signatures from test_rng(), the schnorr-verify
circuit of the bench prove (equal matrices and assignments), the in-circuit
verify rejecting a wrong message, and the smallest gadget circuit
(examples/test_circuit) proved on the CPU with proof and verifying-key bytes
equal to the reference's host prover."""

import os

import pytest
import torch

from simpleworks_tpu import marlin as ref_marlin
from simpleworks_tpu.examples import schnorr_circuit as ref_schnorr_circuit
from simpleworks_tpu.examples import test_circuit as ref_test_circuit
from simpleworks_tpu.marlin import serialization as ref_serde
from simpleworks_tpu.schnorr import schnorr as ref_schnorr
from simpleworks_tpu.utils.rng import test_rng as ref_test_rng
from simpleworks_tpu_torch import marlin
from simpleworks_tpu_torch.examples import schnorr_circuit, test_circuit
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
from simpleworks_tpu_torch.gadgets import Boolean, UInt8Gadget
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.marlin import serialization as serde
from simpleworks_tpu_torch.r1cs.constraint_system import ConstraintSystem
from simpleworks_tpu_torch.schnorr import schnorr
from simpleworks_tpu_torch.schnorr.gadget import (
    ParametersVar, PublicKeyVar, SignatureVar, schnorr_verify_gadget,
)
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


#: the message of the bench prove (bench.py bench_marlin_prove)
MESSAGE = b"a message to sign"
#: SRS(32, 32, 64): degree 189, enough for test_circuit (n = 32, m = 64)
SRS_SIZES = (32, 32, 64)


def signed(pkg, rng_fn):
    """The draw sequence of the bench prove: setup, keygen, sign."""
    rng = rng_fn()
    params = pkg.setup(rng)
    pk, sk = pkg.keygen(params, rng)
    return params, pk, sk, pkg.sign(params, sk, MESSAGE, rng)


@pytest.fixture(scope="module")
def keys():
    return signed(schnorr, test_rng), signed(ref_schnorr, ref_test_rng)


def test_native_signature_matches_reference(keys):
    (params, pk, _, sig), (ref_params, ref_pk, ref_sk, ref_sig) = keys
    assert pk.to_bytes_raw() == ref_pk.to_bytes_raw()
    assert sig.response_bytes() == ref_sig.response_bytes()
    assert sig.verifier_challenge == ref_sig.verifier_challenge
    assert schnorr.verify(params, pk, MESSAGE, sig)
    assert not schnorr.verify(params, pk, b"another message", sig)
    # the reference's verifier accepts the port's signature
    assert ref_schnorr.verify(ref_params, ref_pk, MESSAGE,
                              ref_schnorr.SchnorrSignature(sig.prover_response,
                                                           sig.verifier_challenge))


def test_bench_circuit_matches_reference(keys):
    (params, pk, _, sig), (ref_params, ref_pk, _, ref_sig) = keys
    cs = schnorr_circuit.synthesize(params, pk, MESSAGE, sig)
    ref_cs = ref_schnorr_circuit.synthesize(ref_params, ref_pk, MESSAGE, ref_sig)
    assert cs.num_constraints == ref_cs.num_constraints == 77_012
    assert cs.num_instance_variables == 1  # no public input beyond the constant
    assert cs.instance_assignment == ref_cs.instance_assignment
    assert cs.witness_assignment == ref_cs.witness_assignment
    assert cs.to_matrices() == ref_cs.to_matrices()
    assert cs.is_satisfied()


def test_schnorr_gadget_rejects_wrong_message(keys):
    params, pk, _, sig = keys[0]
    cs = ConstraintSystem(ConstraintF)
    params_var = ParametersVar.new_constant(cs, params)
    pk_var = PublicKeyVar.new_witness(cs, pk)
    bad_msg = [UInt8Gadget.new_witness(cs, b) for b in b"a different message!"]
    sig_var = SignatureVar.new_witness(cs, sig)
    ok = schnorr_verify_gadget(cs, params_var, pk_var, bad_msg, sig_var)
    assert ok.value() is False
    ok.enforce_equal(Boolean.constant(True, cs))
    assert not cs.is_satisfied()


def test_test_circuit_proof_matches_reference_host_prover(monkeypatch):
    monkeypatch.setenv("SWTPU_DEVICE_PROVER", "0")
    monkeypatch.setenv("SWTPU_PK_DISK_CACHE", "0")
    ref_srs = ref_marlin.universal_setup(*SRS_SIZES, ref_marlin.generate_rand())
    ref_cs = ref_test_circuit.synthesize(42, 42)
    ref_pk, ref_vk = ref_marlin.index(ref_srs, ref_cs)
    ref_proof = ref_marlin.prove(ref_pk, ref_cs)

    srs = kzg10.srs_from_reference(
        ref_srs.powers_native, ref_srs.h.serialize_compressed(),
        ref_srs.beta_h.serialize_compressed(),
        [g.serialize_compressed() for g in ref_srs.powers_of_gamma_g], device=CPU)
    cs = test_circuit.synthesize(42, 42)
    assert cs.num_instance_variables == 1 and cs.is_satisfied()
    pk, vk = marlin.index(srs, cs)
    proof = marlin.prove(pk, cs)
    assert serde.serialize_verifying_key(vk) == ref_serde.serialize_verifying_key(ref_vk)
    assert serde.serialize_proof(proof) == ref_serde.serialize_proof(ref_proof)
    assert marlin.verify(vk, [], proof)
    assert not marlin.verify(vk, [1], proof)

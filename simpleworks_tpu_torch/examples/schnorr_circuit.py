"""The ``schnorr-signature`` workload: the SimpleSchnorrSignatureVerification
circuit (reference ``examples/schnorr-signature/main.rs:10-58`` and
``examples/simple-payments/transaction.rs:22-71``).

Everything — parameters (constants), public key, message bytes, signature —
is allocated as witness; the Marlin proof has **empty public inputs**
(reference schnorr-signature/main.rs:177-209).

Port of ``simpleworks_tpu/examples/schnorr_circuit.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..curves.edwards import EdwardsPoint
from ..fields.bls12_377 import ConstraintF
from ..gadgets import Boolean, UInt8Gadget
from ..r1cs.constraint_system import ConstraintSystem
from ..schnorr.gadget import (
    ParametersVar,
    PublicKeyVar,
    SignatureVar,
    schnorr_verify_gadget,
)
from ..schnorr.schnorr import SchnorrParameters, SchnorrSignature


@dataclass
class SimpleSchnorrSignatureVerification:
    parameters: SchnorrParameters
    public_key: EdwardsPoint
    message: bytes
    signature: SchnorrSignature

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        with cs.namespace("parameters"):
            params_var = ParametersVar.new_constant(cs, self.parameters)
        with cs.namespace("public_key"):
            pk_var = PublicKeyVar.new_witness(cs, self.public_key)
        message_var = [UInt8Gadget.new_witness(cs, b) for b in self.message]
        with cs.namespace("signature"):
            sig_var = SignatureVar.new_witness(cs, self.signature)
        result = schnorr_verify_gadget(cs, params_var, pk_var, message_var, sig_var)
        result.enforce_equal(Boolean.constant(True, cs))


def synthesize(parameters, public_key, message, signature) -> ConstraintSystem:
    cs = ConstraintSystem(ConstraintF)
    SimpleSchnorrSignatureVerification(
        parameters, public_key, message, signature
    ).generate_constraints(cs)
    return cs

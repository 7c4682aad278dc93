"""In-circuit Schnorr verification
(reference ``src/schnorr_signature/schnorr_signature_verify_gadget.rs`` and
the ``{parameters,public_key,signature}_var.rs`` allocation wrappers).

The verify gadget performs two variable-base 256-bit scalar multiplications
(generator by s-bits, pubkey by e-bits), a point add, point→bytes
serialization, an in-circuit Blake2s, and a byte-vector equality — the
reference's headline Schnorr circuit shape (SURVEY.md §6).

Port of ``simpleworks_tpu/schnorr/gadget.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves.edwards_gadget import EdwardsVar
from ..gadgets.boolean import Boolean
from ..gadgets.uint import UIntGadget
from ..r1cs.constraint_system import ConstraintSystem
from .blake2s_gadget import blake2s_gadget
from .schnorr import SchnorrParameters, SchnorrSignature


@dataclass
class ParametersVar:
    """Generator (constant) + optional 32-byte salt
    (reference parameters_var.rs:13-63)."""

    generator: EdwardsVar
    salt: Optional[list[UIntGadget]]

    @staticmethod
    def new_constant(cs: ConstraintSystem, params: SchnorrParameters) -> "ParametersVar":
        gen = EdwardsVar.constant(cs, params.generator)
        salt = (
            [UIntGadget.constant(cs, 8, b) for b in params.salt]
            if params.salt is not None
            else None
        )
        return ParametersVar(generator=gen, salt=salt)


@dataclass
class PublicKeyVar:
    """Curve point variable (reference public_key_var.rs:17-86)."""

    pub_key: EdwardsVar

    @staticmethod
    def new_witness(cs: ConstraintSystem, point) -> "PublicKeyVar":
        return PublicKeyVar(pub_key=EdwardsVar.new_witness(cs, point))


@dataclass
class SignatureVar:
    """Response and challenge as UInt8 vectors
    (reference signature_var.rs:21-69: response = 32 LE scalar bytes)."""

    prover_response: list[UIntGadget]
    verifier_challenge: list[UIntGadget]

    @staticmethod
    def new_witness(cs: ConstraintSystem, sig: SchnorrSignature) -> "SignatureVar":
        response_bytes = sig.response_bytes()
        return SignatureVar(
            prover_response=[UIntGadget.new_witness(cs, 8, b) for b in response_bytes],
            verifier_challenge=[
                UIntGadget.new_witness(cs, 8, b) for b in sig.verifier_challenge
            ],
        )


def _bytes_to_bits_le(byte_gadgets: list[UIntGadget]) -> list[Boolean]:
    bits: list[Boolean] = []
    for b in byte_gadgets:
        bits.extend(b.to_bits_le())
    return bits


def _bytes_equal(cs, a: list[UIntGadget], b: list[UIntGadget]) -> Boolean:
    assert len(a) == len(b)
    acc = Boolean.constant(True, cs)
    for x, y in zip(a, b):
        acc = acc.and_(x.is_eq(y))
    return acc


def schnorr_verify_gadget(
    cs: ConstraintSystem,
    parameters: ParametersVar,
    public_key: PublicKeyVar,
    message: list[UIntGadget],
    signature: SignatureVar,
) -> Boolean:
    """reference schnorr_signature_verify_gadget.rs:39-70."""
    response_bits = _bytes_to_bits_le(signature.prover_response)
    challenge_bits = _bytes_to_bits_le(signature.verifier_challenge)

    claimed_commitment = parameters.generator.scalar_mul_le(response_bits)
    pk_times_challenge = public_key.pub_key.scalar_mul_le(challenge_bits)
    claimed_commitment = claimed_commitment.add(pk_times_challenge)

    hash_input: list[UIntGadget] = []
    if parameters.salt is not None:
        hash_input.extend(parameters.salt)
    hash_input.extend(public_key.pub_key.to_bytes())
    hash_input.extend(claimed_commitment.to_bytes())
    hash_input.extend(message)

    obtained = blake2s_gadget(cs, hash_input)
    return _bytes_equal(cs, obtained, signature.verifier_challenge)

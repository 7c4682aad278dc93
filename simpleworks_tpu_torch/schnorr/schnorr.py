"""Native Schnorr signatures over ed-on-bls12-377
(reference ``src/schnorr_signature/schnorr.rs``).

* setup: generator = prime subgroup generator, no salt (schnorr.rs:57-62)
* keygen: x random in the Edwards scalar field, y = xG (schnorr.rs:64-80)
* sign: k random, r = kG, e = Blake2s(salt‖pk‖r‖msg) (32 bytes),
  s = k − x·e with e reduced LE mod the scalar field (schnorr.rs:82-124)
* verify: kG = sG + eY, re-hash, compare the 32 challenge bytes
  (schnorr.rs:126-160)

Point-to-bytes uses the arkworks ``ToBytes`` layout: x‖y raw LE (32+32).

Port of ``simpleworks_tpu/schnorr/schnorr.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ..curves.edwards import EdwardsPoint, prime_subgroup_generator
from ..fields.bls12_377 import FrEd
from ..hash.blake2s import blake2s_digest


@dataclass
class SchnorrParameters:
    generator: EdwardsPoint
    salt: Optional[bytes] = None


@dataclass
class SchnorrSecretKey:
    secret_key: int  # FrEd scalar
    public_key: EdwardsPoint


@dataclass
class SchnorrSignature:
    prover_response: int  # FrEd scalar (s)
    verifier_challenge: bytes  # 32 bytes (e)

    def response_bytes(self) -> bytes:
        """to_bytes![s]: 32 LE bytes of the scalar."""
        return FrEd(self.prover_response).to_bytes_raw()


def setup(_rng=None) -> SchnorrParameters:
    return SchnorrParameters(generator=prime_subgroup_generator(), salt=None)


def keygen(parameters: SchnorrParameters, rng) -> tuple[EdwardsPoint, SchnorrSecretKey]:
    secret = FrEd.rand(rng).value
    public_key = parameters.generator.scalar_mul(secret)
    return public_key, SchnorrSecretKey(secret_key=secret, public_key=public_key)


def _challenge_input(
    parameters: SchnorrParameters,
    public_key: EdwardsPoint,
    commitment: EdwardsPoint,
    message: bytes,
) -> bytes:
    hash_input = b""
    if parameters.salt is not None:
        hash_input += parameters.salt
    hash_input += public_key.to_bytes_raw()
    hash_input += commitment.to_bytes_raw()
    hash_input += message
    return hash_input


def sign(
    parameters: SchnorrParameters, sk: SchnorrSecretKey, message: bytes, rng
) -> SchnorrSignature:
    random_scalar = FrEd.rand(rng).value
    prover_commitment = parameters.generator.scalar_mul(random_scalar)
    verifier_challenge = blake2s_digest(
        _challenge_input(parameters, sk.public_key, prover_commitment, message)
    )
    e = FrEd.from_le_bytes_mod_order(verifier_challenge).value
    s = (random_scalar - e * sk.secret_key) % FrEd.PARAMS.modulus
    return SchnorrSignature(prover_response=s, verifier_challenge=verifier_challenge)


def verify(
    parameters: SchnorrParameters,
    public_key: EdwardsPoint,
    message: bytes,
    signature: SchnorrSignature,
) -> bool:
    e = FrEd.from_le_bytes_mod_order(signature.verifier_challenge).value
    claimed = parameters.generator.scalar_mul(signature.prover_response).add(
        public_key.scalar_mul(e)
    )
    obtained = blake2s_digest(
        _challenge_input(parameters, public_key, claimed, message)
    )
    return signature.verifier_challenge == obtained


def bytes_to_bits_be(data: bytes) -> list[bool]:
    """MSB-first per byte (reference schnorr.rs:183-192)."""
    bits = []
    for byte in data:
        for i in range(8):
            bits.append(((byte >> (7 - i)) & 1) == 1)
    return bits

"""ElGamal encryption over ed-on-bls12-377
(reference integration test ``tests/encrypt.rs``; delegated component
``ark_crypto_primitives::encryption::elgamal`` — SURVEY.md §2.3).

* setup: generator G
* keygen: sk random scalar, pk = sk·G
* encrypt(m ∈ curve, r): (c1, c2) = (r·G, m + r·pk)
* decrypt: m = c2 − sk·c1

Port of ``simpleworks_tpu/elgamal.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from .curves.edwards import EdwardsPoint, prime_subgroup_generator
from .fields.bls12_377 import FrEd


@dataclass
class ElGamalParameters:
    generator: EdwardsPoint


def setup(_rng=None) -> ElGamalParameters:
    return ElGamalParameters(generator=prime_subgroup_generator())


def keygen(params: ElGamalParameters, rng) -> tuple[EdwardsPoint, int]:
    sk = FrEd.rand(rng).value
    pk = params.generator.scalar_mul(sk)
    return pk, sk


def encrypt(
    params: ElGamalParameters, pk: EdwardsPoint, message: EdwardsPoint, rng
) -> tuple[EdwardsPoint, EdwardsPoint]:
    r = FrEd.rand(rng).value
    c1 = params.generator.scalar_mul(r)
    c2 = message.add(pk.scalar_mul(r))
    return c1, c2


def decrypt(
    params: ElGamalParameters, sk: int, ciphertext: tuple[EdwardsPoint, EdwardsPoint]
) -> EdwardsPoint:
    c1, c2 = ciphertext
    return c2.add(c1.scalar_mul(sk).neg())

"""Field-element byte serde (reference ``src/fields/serialization.rs``):
CanonicalSerialize round-trips for ConstraintF.

Port of ``simpleworks_tpu/fields/serialization.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from .bls12_377 import ConstraintF


def serialize_field_element(field_element) -> bytes:
    """reference src/fields/serialization.rs:5-11."""
    if isinstance(field_element, int):
        field_element = ConstraintF(field_element)
    return field_element.serialize()


def deserialize_field_element(data: bytes):
    """reference src/fields/serialization.rs:13-16."""
    return ConstraintF.deserialize(bytes(data))

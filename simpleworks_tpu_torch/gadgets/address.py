"""63-byte Aleo-style address gadget (reference ``src/gadgets/address.rs``).

Stored as 63 UInt8 gadgets; the native value is the 63-byte array, exposed
as a UTF-8 string (reference address.rs:89-109 R1CSVar with Value=String).
ToFieldElements yields 504 LE bits as 0/1 field ints (address.rs:111).

Port of ``simpleworks_tpu/gadgets/address.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..r1cs.constraint_system import ConstraintSystem
from .boolean import Boolean
from .uint import UIntGadget
from ..errors import ensure

ADDRESS_LEN = 63


class AddressGadget:
    __slots__ = ("cs", "bytes", "_value")

    def __init__(self, cs, byte_gadgets: list[UIntGadget], value: bytes):
        assert len(byte_gadgets) == ADDRESS_LEN
        assert len(value) == ADDRESS_LEN
        self.cs = cs
        self.bytes = byte_gadgets
        self._value = bytes(value)

    @staticmethod
    def _coerce(value) -> bytes:
        data = value.encode() if isinstance(value, str) else bytes(value)
        ensure(len(data) == ADDRESS_LEN, f"address must be {ADDRESS_LEN} bytes")
        return data

    @staticmethod
    def new_witness(cs: ConstraintSystem, value) -> "AddressGadget":
        data = AddressGadget._coerce(value)
        return AddressGadget(cs, [UIntGadget.new_witness(cs, 8, b) for b in data], data)

    @staticmethod
    def new_input(cs: ConstraintSystem, value) -> "AddressGadget":
        data = AddressGadget._coerce(value)
        return AddressGadget(cs, [UIntGadget.new_input(cs, 8, b) for b in data], data)

    @staticmethod
    def constant(cs: ConstraintSystem, value) -> "AddressGadget":
        data = AddressGadget._coerce(value)
        return AddressGadget(cs, [UIntGadget.constant(cs, 8, b) for b in data], data)

    # -- introspection -----------------------------------------------------

    def value(self) -> str:
        """UTF-8 string value (reference address.rs:89-109)."""
        return self._value.decode()

    def value_bytes(self) -> bytes:
        return self._value

    def to_bytes(self) -> list[UIntGadget]:
        return list(self.bytes)

    def to_bits_le(self) -> list[Boolean]:
        bits: list[Boolean] = []
        for b in self.bytes:
            bits.extend(b.to_bits_le())
        return bits

    @staticmethod
    def from_bytes_le(byte_gadgets: list[UIntGadget]) -> "AddressGadget":
        value = bytes(b.value() for b in byte_gadgets)
        cs = next((b.cs for b in byte_gadgets if b.cs is not None), None)
        return AddressGadget(cs, list(byte_gadgets), value)

    def is_witness(self) -> bool:
        return self.bytes[0].to_bits_be()[0].is_witness()

    def to_field_elements(self) -> list[int]:
        """504 LE bits as 0/1 ints (reference address.rs:111 &
        traits.rs:246-254)."""
        out: list[int] = []
        for b in self.bytes:
            out.extend(b.to_field_elements())
        return out

    # -- select / equality ----------------------------------------------------

    @staticmethod
    def conditionally_select(cond: Boolean, t: "AddressGadget", f: "AddressGadget") -> "AddressGadget":
        byte_gadgets = [
            UIntGadget.conditionally_select(cond, a, b) for a, b in zip(t.bytes, f.bytes)
        ]
        return AddressGadget.from_bytes_le(byte_gadgets)

    def enforce_equal(self, other: "AddressGadget") -> None:
        for a, b in zip(self.bytes, other.bytes):
            a.enforce_equal(b)

    def is_eq(self, other: "AddressGadget") -> Boolean:
        acc = None
        for a, b in zip(self.bytes, other.bytes):
            eq = a.is_eq(b)
            acc = eq if acc is None else acc.and_(eq)
        return acc

    def __repr__(self):
        return f"Address({self._value!r})"

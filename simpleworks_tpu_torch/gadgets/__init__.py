"""Gadget layer — the circuit "stdlib" (reference ``src/gadgets/``; L2 in
SURVEY.md §1).

Type aliases mirror reference ``src/gadgets/mod.rs:29-39``: every gadget is
bound to ``ConstraintF`` = BLS12-377 Fr (the base field of ed-on-bls12-377).
Width-specific UInt aliases are factory helpers over the single
width-parametric :class:`UIntGadget`.

Port of ``simpleworks_tpu/gadgets/__init__.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from functools import partial

from ..fields.bls12_377 import ConstraintF
from .boolean import Boolean
from .field_var import FieldVar
from .uint import Comparison, UIntGadget, compare_ord, rotate_bytes_left, rotate_bytes_right
from .int8 import Int8Gadget, to_absolute_value, to_two_complement
from .address import AddressGadget


class _UIntAlias:
    """Bound-width facade over UIntGadget (e.g. UInt8Gadget.new_witness(cs, v))."""

    def __init__(self, width: int):
        self.width = width

    def new_witness(self, cs, value):
        return UIntGadget.new_witness(cs, self.width, value)

    def new_input(self, cs, value):
        return UIntGadget.new_input(cs, self.width, value)

    def constant(self, cs, value):
        return UIntGadget.constant(cs, self.width, value)

    def from_bits_le(self, bits):
        return UIntGadget.from_bits_le(self.width, bits)

    def from_bytes_le(self, bytes_gadgets):
        return UIntGadget.from_bytes_le(self.width, bytes_gadgets)

    def from_bytes_be(self, bytes_gadgets):
        return UIntGadget.from_bytes_be(self.width, bytes_gadgets)


UInt8Gadget = _UIntAlias(8)
UInt16Gadget = _UIntAlias(16)
UInt32Gadget = _UIntAlias(32)
UInt64Gadget = _UIntAlias(64)
UInt128Gadget = _UIntAlias(128)
FieldGadget = FieldVar

# new_input_vec lives on UInt8 in arkworks; exposed here for parity.
UInt8Gadget.new_input_vec = staticmethod(UIntGadget.new_input_vec)


def to_field_elements_int(value: int, width: int) -> list[int]:
    """``ToFieldElements`` for native uN/iN values: LE bits as 0/1 ints
    (reference src/gadgets/traits.rs:150-254)."""
    mask = (1 << width) - 1
    v = value & mask
    return [(v >> i) & 1 for i in range(width)]


def address_to_field_elements(address: bytes) -> list[int]:
    """``ToFieldElements`` for [u8; 63] (reference traits.rs:246-254)."""
    out = []
    for byte in address:
        out.extend(to_field_elements_int(byte, 8))
    return out


__all__ = [
    "Boolean",
    "FieldVar",
    "FieldGadget",
    "UIntGadget",
    "UInt8Gadget",
    "UInt16Gadget",
    "UInt32Gadget",
    "UInt64Gadget",
    "UInt128Gadget",
    "Int8Gadget",
    "AddressGadget",
    "Comparison",
    "ConstraintF",
    "compare_ord",
    "rotate_bytes_left",
    "rotate_bytes_right",
    "to_absolute_value",
    "to_two_complement",
    "to_field_elements_int",
    "address_to_field_elements",
]

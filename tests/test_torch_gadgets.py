"""The port's gadget layer (simpleworks_tpu_torch.gadgets) held against the
JAX package's: one circuit per gadget family is built by both packages on the
same seed-made inputs, and the two constraint systems must be equal — the
A/B/C matrices of ``to_matrices()``, the instance and witness assignments,
``is_satisfied`` — as must every gadget's value."""

import numpy as np
import pytest

import simpleworks_tpu.gadgets as ref_gadgets
from simpleworks_tpu.fields.bls12_377 import ConstraintF as RefF
from simpleworks_tpu.r1cs.constraint_system import ConstraintSystem as RefCS
import simpleworks_tpu_torch.gadgets as gadgets
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
from simpleworks_tpu_torch.r1cs.constraint_system import ConstraintSystem

PACKAGES = {"port": (gadgets, ConstraintSystem, ConstraintF),
            "reference": (ref_gadgets, RefCS, RefF)}


def boolean_circuit(g, cs, rng):
    a, b = (g.Boolean.new_witness(cs, bool(v)) for v in rng.integers(0, 2, 2))
    c = g.Boolean.new_input(cs, True)
    outs = [a.and_(b), a.or_(c), a.xor(b), a.nand(c), b.nor(c), a.not_(),
            g.Boolean.kary_nand([a, b, c]), g.Boolean.conditionally_select(c, a, b), a.is_eq(b)]
    c.enforce_equal(g.Boolean.constant(True, cs))
    return [o.value() for o in outs]


def uint_circuit(width):
    def build(g, cs, rng):
        vx, vy = sorted(int.from_bytes(rng.bytes(width // 8), "little") for _ in range(2))
        vy, vx = vx, vy | 1  # x >= y, x odd (a nonzero divisor)
        x = g.UIntGadget.new_witness(cs, width, vx)
        y = g.UIntGadget.new_input(cs, width, vy)
        k = g.UIntGadget.constant(cs, width, 5)
        outs = [x.add(y), x.sub(y), x.xor(y), x.and_(k), x.not_(), x.rotate_left(3, cs),
                y.shift_right(5, cs), x.compare(y, g.Comparison.GREATER_THAN, cs),
                g.UIntGadget.addmany([x, y, k], cs), x.is_eq(y),
                g.UIntGadget.conditionally_select(x.is_eq(x), y, x)]
        if width <= 16:  # shift-and-add and long division grow as width²
            outs += [x.mul(y, cs), y.div(x, cs)]
        outs[-1].enforce_equal(outs[-1])
        return [o.value() for o in outs] + [x.to_field_elements()]
    return build


def int8_circuit(g, cs, rng):
    vx, vy = (int(v) for v in rng.integers(-60, 60, 2))
    x = g.Int8Gadget.new_witness(cs, vx)
    y = g.Int8Gadget.new_input(cs, vy or 7)
    outs = [x.add(y), x.sub(y), x.mul(y, cs), x.div(y, cs), x.shift_right(2, cs),
            x.rotate_left(3, cs), x.xor(y), g.to_absolute_value(g.Int8Gadget.constant(cs, -9), cs),
            g.to_two_complement(g.Int8Gadget.constant(cs, 9), cs),
            x.compare(y, g.Comparison.LESS_THAN, cs), x.is_eq(y)]
    return [o.value() for o in outs]


def field_var_circuit(g, cs, rng):
    vx, vy = (int.from_bytes(rng.bytes(32), "little") % P or 1 for _ in range(2))
    x = g.FieldVar.new_witness(cs, vx)
    y = g.FieldVar.new_input(cs, vy)
    c = g.FieldVar.constant(cs, 12345)
    outs = [x.add(y), x.sub(c), x.neg(), x.mul(y), x.mul_by_constant(7), x.square(),
            x.pow_by_constant(11), x.inverse(), x.is_eq(y),
            g.FieldVar.conditionally_select(x.is_eq(x), x, y)]
    outs[-1].enforce_equal(x)
    bits = y.to_bits_le(64) if vy < 1 << 64 else x.to_bits_le()
    return [o.value() for o in outs] + [[b.value() for b in bits]]


def address_circuit(g, cs, rng):
    data = bytes(int(v) for v in rng.integers(ord("a"), ord("z") + 1, 63))
    a = g.AddressGadget.new_witness(cs, data)
    b = g.AddressGadget.new_input(cs, data[::-1])
    sel = g.AddressGadget.conditionally_select(a.is_eq(b), b, a)
    sel.enforce_equal(a)
    return [a.value(), b.value(), sel.value(), a.is_eq(b).value(), a.to_field_elements()[:16]]


FAMILIES = {"boolean": boolean_circuit, **{f"uint{w}": uint_circuit(w) for w in (8, 16, 32, 64, 128)},
            "int8": int8_circuit, "field_var": field_var_circuit, "address": address_circuit}


@pytest.mark.parametrize("family", list(FAMILIES))
def test_gadget_constraint_systems_match_reference(family):
    built = {}
    for name, (g, cs_cls, field) in PACKAGES.items():
        cs = cs_cls(field)
        values = FAMILIES[family](g, cs, np.random.default_rng(len(family)))
        built[name] = (cs, values)
    (cs, values), (ref_cs, ref_values) = built["port"], built["reference"]
    assert values == ref_values
    assert cs.num_constraints > 0
    assert cs.to_matrices() == ref_cs.to_matrices()
    assert cs.instance_assignment == ref_cs.instance_assignment
    assert cs.witness_assignment == ref_cs.witness_assignment
    assert cs.is_satisfied() and ref_cs.is_satisfied()

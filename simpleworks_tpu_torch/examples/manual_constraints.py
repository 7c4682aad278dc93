"""The ``manual-constraints`` workload (reference
``examples/manual-constraints.rs``; port of
``simpleworks_tpu/examples/manual_constraints.py``): the equality circuit built from
raw R1CS variables, no gadgets — one public input, one witness, and the
constraint (input - witness) * 1 = 0.
"""

from __future__ import annotations

from ..fields.bls12_377 import ConstraintF
from ..r1cs.constraint_system import ONE, ConstraintSystem


def synthesize(public_number: int, witness_number: int) -> ConstraintSystem:
    """reference examples/manual-constraints.rs:21-28."""
    cs = ConstraintSystem(ConstraintF)
    a = cs.new_input_variable(public_number)
    b = cs.new_witness_variable(witness_number)
    cs.enforce_constraint(
        cs.lc((1, a)) - cs.lc((1, b)),  # a - b
        cs.lc((1, ONE)),                # 1
        cs.lc(),                        # 0
    )
    return cs

"""The Merkle membership circuit for u8 leaves
(reference ``src/merkle_tree/merkle_tree_verification_u8.rs``).

Public inputs: [root, leaf bits (8 × 0/1)] — the exact layout the verifier
rebuilds in simple_merkle_tree.rs:129-143.  Witness: the authentication
path.  CRH parameters are circuit constants.

Port of ``simpleworks_tpu/merkle/circuit.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..fields.bls12_377 import ConstraintF
from ..gadgets.field_var import FieldVar
from ..gadgets.boolean import Boolean
from ..gadgets.uint import UIntGadget
from ..hash.pedersen import PedersenParameters
from ..r1cs.constraint_system import ConstraintSystem
from .gadget import MerklePathVar
from .tree import MerklePath


@dataclass
class MerkleTreeVerificationU8:
    leaf_crh_params: PedersenParameters
    two_to_one_crh_params: PedersenParameters
    root: int
    leaf: int
    authentication_path: MerklePath

    def generate_constraints(self, cs: ConstraintSystem) -> None:
        with cs.namespace("root_var"):
            root_var = FieldVar.new_input(cs, self.root)
        with cs.namespace("leaf_var"):
            leaf_var = UIntGadget.new_input(cs, 8, self.leaf)
        with cs.namespace("path_var"):
            path_var = MerklePathVar.new_witness(cs, self.authentication_path)
        is_member = path_var.verify_membership(
            self.leaf_crh_params,
            self.two_to_one_crh_params,
            root_var,
            [leaf_var],
        )
        is_member.enforce_equal(Boolean.constant(True, cs))


def public_inputs_for_verify(root: int, leaf: int) -> list[int]:
    """[root, leaf bits LE as 0/1] (reference simple_merkle_tree.rs:129-143)."""
    return [root] + [(leaf >> i) & 1 for i in range(8)]


def synthesize(leaf_params, two_params, root, leaf, path) -> ConstraintSystem:
    cs = ConstraintSystem(ConstraintF)
    MerkleTreeVerificationU8(leaf_params, two_params, root, leaf, path).generate_constraints(cs)
    return cs

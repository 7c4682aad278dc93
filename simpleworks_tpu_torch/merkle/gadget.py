"""In-circuit Merkle membership verification (the ``PathVar`` slot;
reference ``SimplePathVar`` in src/merkle_tree/simple_merkle_tree.rs:23 and
``verify_membership`` usage in merkle_tree_verification_u8.rs:50-56).

Witnesses: the bottom-up sibling digests and the leaf-index bits; the root
is recomputed with the in-circuit Pedersen CRH and compared to the public
root variable.

Port of ``simpleworks_tpu/merkle/gadget.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..gadgets.boolean import Boolean
from ..gadgets.field_var import FieldVar
from ..hash.pedersen import PedersenParameters
from ..hash.pedersen_gadget import pedersen_evaluate_gadget
from .tree import MerklePath


class MerklePathVar:
    __slots__ = ("cs", "position_bits", "sibling_vars")

    def __init__(self, cs, position_bits: list[Boolean], sibling_vars: list[FieldVar]):
        self.cs = cs
        self.position_bits = position_bits
        self.sibling_vars = sibling_vars

    @staticmethod
    def new_witness(cs, path: MerklePath) -> "MerklePathVar":
        position_bits = [
            Boolean.new_witness(cs, (path.leaf_index >> i) & 1 == 1)
            for i in range(len(path.auth_path))
        ]
        sibling_vars = [FieldVar.new_witness(cs, s) for s in path.auth_path]
        return MerklePathVar(cs, position_bits, sibling_vars)

    def verify_membership(
        self,
        leaf_params: PedersenParameters,
        two_to_one_params: PedersenParameters,
        root_var: FieldVar,
        leaf_bytes: list,
    ) -> Boolean:
        """Recompute the root in-circuit; returns the membership Boolean."""
        cs = self.cs
        current = pedersen_evaluate_gadget(cs, leaf_params, leaf_bytes)
        for bit, sibling in zip(self.position_bits, self.sibling_vars):
            # bit == 1 → current node is the right child
            left = FieldVar.conditionally_select(bit, sibling, current)
            right = FieldVar.conditionally_select(bit, current, sibling)
            data = left.to_bytes() + right.to_bytes()
            current = pedersen_evaluate_gadget(cs, two_to_one_params, data)
        return current.is_eq(root_var)

"""The ``merkle-tree`` workload (reference ``examples/merkle-tree/main.rs``):
an 8-leaf Pedersen Merkle tree with the u8 membership circuit.

The circuit/commons live in :mod:`simpleworks_tpu_torch.merkle` (the reference
duplicates them between src and the example); this module binds the
example's concrete workload shape.

Port of ``simpleworks_tpu/examples/merkle_tree.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..hash.pedersen import LEAF_WINDOW, TWO_TO_ONE_WINDOW, pedersen_setup
from ..merkle.circuit import (
    MerkleTreeVerificationU8,
    public_inputs_for_verify,
    synthesize,
)
from ..merkle.tree import MerkleTree
from ..utils.rng import test_rng

#: the reference example's leaves (examples/merkle-tree/main.rs:116)
EXAMPLE_LEAVES = [1, 2, 3, 10, 9, 17, 70, 45]


def build_example_tree():
    rng = test_rng()
    leaf_params = pedersen_setup(LEAF_WINDOW, rng)
    two_params = pedersen_setup(TWO_TO_ONE_WINDOW, rng)
    tree = MerkleTree.new(
        leaf_params, two_params, [bytes([v]) for v in EXAMPLE_LEAVES]
    )
    return tree, leaf_params, two_params

"""Self-proving Merkle tree (reference ``src/merkle_tree/simple_merkle_tree.rs``).

``SimpleMerkleTree.new`` builds the tree, samples a universal SRS and
derives Marlin proving/verifying keys from a blank-tree dummy circuit so
they can be reused for every proof at that height (the reference's pk/vk
caching rationale, simple_merkle_tree.rs:51-58).

``srs_scale`` defaults to the reference's (100_000, 25_000, 300_000)
(simple_merkle_tree.rs:39); tests may inject smaller scales together with
smaller Pedersen windows to keep CPU runtimes sane — the circuit logic is
identical at every scale.

The SRS, the index and the prove run on ``device`` (resolved by
:func:`simpleworks_tpu_torch.device.resolve` in the setup): the card unless
the caller names another (``device="cpu"``), or the injected ``srs``'s
device.  Verify is host arithmetic.

Port of ``simpleworks_tpu/merkle/simple_merkle_tree.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from typing import Optional

from .. import marlin
from ..fields.bls12_377 import ConstraintF
from ..hash.pedersen import (
    LEAF_WINDOW,
    TWO_TO_ONE_WINDOW,
    PedersenWindow,
    pedersen_setup,
)
from ..marlin.serialization import deserialize_proof, serialize_proof
from ..r1cs.constraint_system import ConstraintSystem
from ..utils.rng import test_rng
from .circuit import MerkleTreeVerificationU8, public_inputs_for_verify
from .tree import MerklePath, MerkleTree, merkle_tree_height

from ..config import DEFAULT_CONFIG

#: reference src/merkle_tree/simple_merkle_tree.rs:39
REFERENCE_SRS_SCALE = DEFAULT_CONFIG.large_srs


class SimpleMerkleTree:
    def __init__(
        self,
        leaves: list[int],
        srs_scale: tuple[int, int, int] = REFERENCE_SRS_SCALE,
        leaf_window: PedersenWindow = LEAF_WINDOW,
        two_to_one_window: PedersenWindow = TWO_TO_ONE_WINDOW,
        srs: Optional[object] = None,
        device=None,
    ):
        """reference SimpleMerkleTree::new (simple_merkle_tree.rs:35-92)."""
        rng = test_rng()
        if srs is None:
            srs = marlin.universal_setup(*srs_scale, rng, device=device)
        self.leaf_crh_params = pedersen_setup(leaf_window, rng)
        self.two_to_one_crh_params = pedersen_setup(two_to_one_window, rng)
        self.tree = MerkleTree.new(
            self.leaf_crh_params,
            self.two_to_one_crh_params,
            [bytes([leaf]) for leaf in leaves],
        )
        # blank tree fixes the circuit shape for this height → reusable pk/vk
        blank = MerkleTree.blank(
            self.leaf_crh_params,
            self.two_to_one_crh_params,
            merkle_tree_height(len(leaves)),
        )
        blank_path = blank.generate_proof(0)
        dummy_cs = ConstraintSystem(ConstraintF)
        MerkleTreeVerificationU8(
            leaf_crh_params=self.leaf_crh_params,
            two_to_one_crh_params=self.two_to_one_crh_params,
            root=blank.root(),
            leaf=0,
            authentication_path=blank_path,
        ).generate_constraints(dummy_cs)
        self.proving_key, self.verifying_key = marlin.index(srs, dummy_cs)

    def get_merkle_path(self, leaf_index: int) -> MerklePath:
        """reference simple_merkle_tree.rs:94-100."""
        return self.tree.generate_proof(leaf_index)

    def prove(self, leaf: int, merkle_path: MerklePath) -> bytes:
        """Serialized Marlin membership proof (simple_merkle_tree.rs:102-127)."""
        cs = ConstraintSystem(ConstraintF)
        MerkleTreeVerificationU8(
            leaf_crh_params=self.leaf_crh_params,
            two_to_one_crh_params=self.two_to_one_crh_params,
            root=self.tree.root(),
            leaf=leaf,
            authentication_path=merkle_path,
        ).generate_constraints(cs)
        proof = marlin.prove(self.proving_key, cs, test_rng())
        return serialize_proof(proof)

    def verify(self, proof_bytes: bytes, leaf: int) -> bool:
        """Rebuild the public inputs [root, leaf bits] and verify
        (simple_merkle_tree.rs:129-152)."""
        inputs = public_inputs_for_verify(self.tree.root(), leaf)
        proof = deserialize_proof(proof_bytes)
        return marlin.verify(self.verifying_key, inputs, proof, test_rng())


def check_leave_exists_u8(tree: SimpleMerkleTree, leaf: int, path: MerklePath) -> bool:
    """Satisfiability check without proving (simple_merkle_tree.rs:165-202)."""
    cs = ConstraintSystem(ConstraintF)
    MerkleTreeVerificationU8(
        leaf_crh_params=tree.leaf_crh_params,
        two_to_one_crh_params=tree.two_to_one_crh_params,
        root=tree.tree.root(),
        leaf=leaf,
        authentication_path=path,
    ).generate_constraints(cs)
    return cs.is_satisfied()

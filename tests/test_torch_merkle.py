"""The port's Merkle stack (simpleworks_tpu_torch.merkle) held against the JAX
package's: the example tree at the reference windows (roots, every level,
paths, update, the blank tree), and the membership circuit at tiny windows,
whose constraint matrices and full assignment must be equal term for term.
Tolerance 0. The port's SimpleMerkleTree round trip on the CPU (index, prove,
verify) is under ``slow``, as the reference's is
(tests/test_simple_merkle_tree.py)."""

import os

import pytest
import torch

from simpleworks_tpu.examples import merkle_tree as ref_example
from simpleworks_tpu.hash import pedersen as ref_pedersen
from simpleworks_tpu.merkle import circuit as ref_circuit
from simpleworks_tpu.merkle import tree as ref_tree
from simpleworks_tpu.utils.rng import test_rng as ref_test_rng
from simpleworks_tpu_torch.examples import merkle_tree as example
from simpleworks_tpu_torch.hash import pedersen
from simpleworks_tpu_torch.merkle import circuit, tree
from simpleworks_tpu_torch.merkle.simple_merkle_tree import (
    SimpleMerkleTree,
    check_leave_exists_u8,
)

os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # host arithmetic only: more threads only contend with the other workers


@pytest.fixture(autouse=True, scope="module")
def _no_disk_checkpoints():
    """The disk checkpoints off: every setup and index of this file is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_SRS_DISK_CACHE", "0")
        mp.setenv("SWTPU_PK_DISK_CACHE", "0")
        yield


#: the reference's demo shape of the self-proving tree (examples/run.py): a
#: 2-byte leaf window, the 512-bit two-to-one window, 2 leaves
TINY_LEAF_WINDOW = (4, 4)
TWO_TO_ONE_WINDOW = (4, 128)
TINY_LEAVES = [1, 2]
#: an SRS just large enough for that circuit (n = m = 8192): the CPU's MSMs
#: make the round trip take about half an hour even so
SMALL_SCALE = (8_192, 8_192, 8_192)


def levels(t):
    return [list(level) for level in t.levels]


@pytest.fixture(scope="module")
def example_trees():
    """Each package's example tree (the reference's 8 leaves, windows 4x144 /
    4x128, parameters from test_rng())."""
    return example.build_example_tree(), ref_example.build_example_tree()


def test_example_tree_matches_reference(example_trees):
    (t, leaf_params, two_params), (ref_t, ref_leaf, ref_two) = example_trees
    assert example.EXAMPLE_LEAVES == ref_example.EXAMPLE_LEAVES
    assert t.height == ref_t.height == tree.merkle_tree_height(8) == 4
    assert levels(t) == levels(ref_t)
    for i, leaf in enumerate(example.EXAMPLE_LEAVES):
        path, ref_path = t.generate_proof(i), ref_t.generate_proof(i)
        assert (path.leaf_index, path.auth_path) == (ref_path.leaf_index, ref_path.auth_path)
        assert path.verify(leaf_params, two_params, t.root(), bytes([leaf]))
        assert not path.verify(leaf_params, two_params, t.root(), bytes([leaf ^ 0x40]))
    assert tree.digest_to_bytes(t.root()) == ref_tree.digest_to_bytes(ref_t.root())


def test_update_and_blank_match_reference(example_trees):
    (_, leaf_params, two_params), (_, ref_leaf, ref_two) = example_trees
    leaves = [bytes([v]) for v in example.EXAMPLE_LEAVES]
    t = tree.MerkleTree.new(leaf_params, two_params, leaves)
    ref_t = ref_tree.MerkleTree.new(ref_leaf, ref_two, leaves)
    for index, data in ((0, b"\x04"), (5, b"\xff"), (7, bytes(9))):
        t.update(index, data)
        ref_t.update(index, data)
        assert levels(t) == levels(ref_t)
    blank = tree.MerkleTree.blank(leaf_params, two_params, 4)
    ref_blank = ref_tree.MerkleTree.blank(ref_leaf, ref_two, 4)
    assert levels(blank) == levels(ref_blank)
    path, ref_path = blank.generate_proof(3), ref_blank.generate_proof(3)
    assert path.auth_path == ref_path.auth_path
    assert [tree.merkle_tree_height(n) for n in range(70)] == \
        [ref_tree.merkle_tree_height(n) for n in range(70)]


@pytest.fixture(scope="module")
def tiny():
    """The reference's tiny-tree parameters and tree, and the port's built
    from the same generators (parameters_from_reference)."""
    ref_leaf = ref_pedersen.pedersen_setup(ref_pedersen.PedersenWindow(*TINY_LEAF_WINDOW),
                                           ref_test_rng())
    ref_two = ref_pedersen.pedersen_setup(ref_pedersen.PedersenWindow(*TWO_TO_ONE_WINDOW),
                                          ref_test_rng())
    leaf_params, two_params = (
        pedersen.parameters_from_reference(
            pedersen.PedersenWindow(*window),
            [[pt.to_affine() for pt in powers] for powers in params.generators])
        for window, params in ((TINY_LEAF_WINDOW, ref_leaf), (TWO_TO_ONE_WINDOW, ref_two)))
    leaves = [bytes([v]) for v in TINY_LEAVES]
    return ((leaf_params, two_params, tree.MerkleTree.new(leaf_params, two_params, leaves)),
            (ref_leaf, ref_two, ref_tree.MerkleTree.new(ref_leaf, ref_two, leaves)))


@pytest.mark.parametrize("leaf, satisfied", [(TINY_LEAVES[1], True), (TINY_LEAVES[0], False)],
                         ids=["member", "wrong_leaf"])
def test_membership_circuit_matches_reference(tiny, leaf, satisfied):
    (leaf_params, two_params, t), (ref_leaf, ref_two, ref_t) = tiny
    assert t.root() == ref_t.root()
    path, ref_path = t.generate_proof(1), ref_t.generate_proof(1)
    cs = circuit.synthesize(leaf_params, two_params, t.root(), leaf, path)
    ref_cs = ref_circuit.synthesize(ref_leaf, ref_two, ref_t.root(), leaf, ref_path)
    assert cs.num_constraints == ref_cs.num_constraints == 4_202
    assert cs.num_instance_variables == ref_cs.num_instance_variables == 10
    assert cs.to_matrices() == ref_cs.to_matrices()
    assert cs.full_assignment() == ref_cs.full_assignment()
    assert cs.is_satisfied() is ref_cs.is_satisfied() is satisfied
    assert cs.instance_assignment[1:] == circuit.public_inputs_for_verify(t.root(), leaf)


def test_public_inputs_for_verify_matches_reference():
    root = 0x1234_5678_9ABC_DEF0 << 180
    for leaf in (0, 1, 77, 0xA5, 255):
        assert circuit.public_inputs_for_verify(root, leaf) == \
            ref_circuit.public_inputs_for_verify(root, leaf)


@pytest.mark.slow
def test_simple_merkle_tree_cpu_round_trip():
    """The port's self-proving tree on the CPU at the reference's demo shape
    (reference simple_merkle_tree.rs:276-292)."""
    t = SimpleMerkleTree(TINY_LEAVES, srs_scale=SMALL_SCALE,
                         leaf_window=pedersen.PedersenWindow(*TINY_LEAF_WINDOW),
                         two_to_one_window=pedersen.PedersenWindow(*TWO_TO_ONE_WINDOW),
                         device="cpu")
    path = t.get_merkle_path(0)
    assert check_leave_exists_u8(t, 1, path) and not check_leave_exists_u8(t, 77, path)
    proof_bytes = t.prove(1, path)
    assert t.verify(proof_bytes, 1)
    assert not t.verify(proof_bytes, 2)

"""Merkle tree over Pedersen CRH digests.

Replaces ``ark_crypto_primitives::merkle_tree`` (SURVEY.md §2.3 'Merkle
tree'; reference call sites ``src/merkle_tree/simple_merkle_tree.rs:47-66``,
``examples/simple-payments/ledger.rs:105-172``).

* power-of-two leaf count; height = log2(n) + 1 (8 leaves → height 4)
* leaf digest  = LeafHash(leaf bytes)
* inner digest = TwoToOneHash(left digest bytes || right digest bytes)
  with digests serialized as 32-byte raw LE (arkworks ``ToBytes`` for Fq)
* ``blank``: all-default (zero) leaf digests, used only to fix circuit shape
  for key derivation (reference simple_merkle_tree.rs:51-64)
* ``update``: incremental single-leaf update re-hashing one path

The Path layout here is a clean bottom-up sibling list (the reference's
arkworks Path stores (left, right) pairs; equivalent information, simpler
in-circuit logic).

Port of ``simpleworks_tpu/merkle/tree.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..errors import ensure
from ..fields.bls12_377 import ConstraintF
from ..hash.pedersen import (
    PedersenParameters,
    pedersen_evaluate,
    pedersen_evaluate_two_to_one,
)


def digest_to_bytes(digest: int) -> bytes:
    """arkworks ``ToBytes`` for an Fq digest: 32 raw LE bytes."""
    return ConstraintF(digest).to_bytes_raw()


@dataclass
class MerklePath:
    """Bottom-up authentication path for ``leaf_index``."""

    leaf_index: int
    auth_path: list[int]  # sibling digests, leaf level first

    def verify(
        self,
        leaf_params: PedersenParameters,
        two_to_one_params: PedersenParameters,
        root: int,
        leaf_bytes: bytes,
    ) -> bool:
        """reference Path::verify semantics (transaction.rs:162-174 usage)."""
        current = pedersen_evaluate(leaf_params, leaf_bytes)
        index = self.leaf_index
        for sibling in self.auth_path:
            left, right = (current, sibling) if index % 2 == 0 else (sibling, current)
            current = pedersen_evaluate_two_to_one(
                two_to_one_params, digest_to_bytes(left), digest_to_bytes(right)
            )
            index //= 2
        return current == root


class MerkleTree:
    def __init__(
        self,
        leaf_params: PedersenParameters,
        two_to_one_params: PedersenParameters,
        leaf_digests: list[int],
    ):
        n = len(leaf_digests)
        ensure(n >= 2 and n & (n - 1) == 0, "leaf count must be a power of two >= 2")
        self.leaf_params = leaf_params
        self.two_to_one_params = two_to_one_params
        self.levels: list[list[int]] = [list(leaf_digests)]
        while len(self.levels[-1]) > 1:
            prev = self.levels[-1]
            nxt = [
                pedersen_evaluate_two_to_one(
                    two_to_one_params,
                    digest_to_bytes(prev[2 * i]),
                    digest_to_bytes(prev[2 * i + 1]),
                )
                for i in range(len(prev) // 2)
            ]
            self.levels.append(nxt)

    # -- constructors ------------------------------------------------------

    @classmethod
    def new(cls, leaf_params, two_to_one_params, leaves: list[bytes]) -> "MerkleTree":
        digests = [pedersen_evaluate(leaf_params, leaf) for leaf in leaves]
        return cls(leaf_params, two_to_one_params, digests)

    @classmethod
    def blank(cls, leaf_params, two_to_one_params, height: int) -> "MerkleTree":
        """Shape-only tree with default (zero) leaf digests
        (reference simple_merkle_tree.rs:59-64)."""
        num_leaves = 1 << (height - 1)
        return cls(leaf_params, two_to_one_params, [0] * num_leaves)

    # -- queries ----------------------------------------------------------------

    @property
    def height(self) -> int:
        return len(self.levels)

    def root(self) -> int:
        return self.levels[-1][0]

    def leaf_digest(self, index: int) -> int:
        return self.levels[0][index]

    def generate_proof(self, index: int) -> MerklePath:
        auth = []
        idx = index
        for level in self.levels[:-1]:
            sibling = level[idx ^ 1]
            auth.append(sibling)
            idx //= 2
        return MerklePath(leaf_index=index, auth_path=auth)

    # -- mutation -----------------------------------------------------------------

    def update(self, index: int, new_leaf_bytes: bytes) -> None:
        """Incremental update of one leaf (reference ledger.rs:166-173)."""
        digest = pedersen_evaluate(self.leaf_params, new_leaf_bytes)
        self.levels[0][index] = digest
        idx = index
        for level_num in range(1, len(self.levels)):
            below = self.levels[level_num - 1]
            parent = idx // 2
            self.levels[level_num][parent] = pedersen_evaluate_two_to_one(
                self.two_to_one_params,
                digest_to_bytes(below[2 * parent]),
                digest_to_bytes(below[2 * parent + 1]),
            )
            idx = parent


def merkle_tree_height(leaves_length: int) -> int:
    """Bit-length height rule (reference simple_merkle_tree.rs:155-163)."""
    result = 0
    while leaves_length != 0:
        result += 1
        leaves_length >>= 1
    return result

"""The reference results of the merkle-tree and simple-payments workloads, kept
in tests/torch_fixtures/merkle_tree_reference.json. chip_smoke.py holds the
card's against them.

* ``merkle``: the JAX package's host prover on the merkle-tree workload at
  the reference's parameters: ``SimpleMerkleTree([1, 2, 3, 10, 9, 17, 70,
  45])`` (Pedersen windows 4x144 / 4x128, SRS(100_000, 25_000, 300_000),
  all from ``test_rng()``), then ``prove(1, get_merkle_path(0))``. The
  verifying key and the proof, hex with sha256, and the tree's root.
* ``payments``: the demo sequence of the simple-payments workload
  (``run_simple_payments``): a 32-account ledger from
  ``Parameters.sample(test_rng())``, alice registered with balance 10, then
  bob; a transfer of 5 (validate, then apply), an overspend of 6, a forged
  signature and an unknown recipient. The verdicts, the final balances and
  the account tree's roots after the registrations and after the transfer.
  These depend only on the keys and the balances, which are drawn before the
  first validate, and not on the per-transaction Marlin leg's draws: so the
  JAX side makes them with ``prove_transactions=False``, in about a second,
  and the card's run with ``prove_transactions=True`` must give the same.

Regenerate the file (one to two minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_merkle_fixture.py --write

and check it against a fresh reference run with
``pytest -m "slow and fullscale" tests/test_torch_merkle_fixture.py``.
"""

import hashlib
import json
import os
import pathlib
import sys

import pytest

FIXTURE = pathlib.Path(__file__).parent / "torch_fixtures" / "merkle_tree_reference.json"
LEAVES = [1, 2, 3, 10, 9, 17, 70, 45]
SRS_SIZES = (100_000, 25_000, 300_000)
#: the membership circuit of 8 leaves at the reference windows
NUM_CONSTRAINTS = 15_198
#: the serialized proof of a Marlin prove with nine public inputs
PROOF_BYTES = 1431
#: the verdicts of the payments sequence, in order
VERDICTS = ["transfer_validate", "transfer_apply", "overspend", "forged_signature",
            "unknown_recipient"]
#: the reference's environment: its host prover, no key read from disk, no
#: SRS written to disk
REFERENCE_ENV = {"SWTPU_DEVICE_PROVER": "0", "SWTPU_PK_DISK_CACHE": "0",
                 "SWTPU_SRS_DISK_CACHE": "0"}


def entry(data: bytes) -> dict:
    return {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(), "hex": data.hex()}


def reference_merkle() -> dict:
    """The reference's merkle-tree workload at its own parameters."""
    from simpleworks_tpu.marlin.serialization import serialize_verifying_key
    from simpleworks_tpu.merkle.simple_merkle_tree import SimpleMerkleTree

    tree = SimpleMerkleTree(LEAVES)
    path = tree.get_merkle_path(0)
    proof_bytes = tree.prove(LEAVES[0], path)
    if not tree.verify(proof_bytes, LEAVES[0]) or tree.verify(proof_bytes, 77):
        raise AssertionError("the reference's membership proof verifies wrongly")
    return {"leaves": LEAVES, "srs_sizes": list(SRS_SIZES), "leaf_window": [4, 144],
            "two_to_one_window": [4, 128], "num_constraints": tree.verifying_key.info.num_constraints,
            "root": hex(tree.tree.root()),
            "verifying_key": entry(serialize_verifying_key(tree.verifying_key)),
            "proof": entry(proof_bytes)}


def reference_payments() -> dict:
    """The reference's simple-payments demo sequence without the Marlin leg:
    its verdicts, the final balances and the roots."""
    from simpleworks_tpu.examples.simple_payments.account import AccountId
    from simpleworks_tpu.examples.simple_payments.ledger import Parameters, State
    from simpleworks_tpu.examples.simple_payments.transaction import Transaction
    from simpleworks_tpu.utils.rng import test_rng

    rng = test_rng()
    pp = Parameters.sample(rng, prove_transactions=False)
    state = State(32, pp)
    alice, _, alice_sk = state.sample_keys_and_register(pp, rng)
    state.update_balance(alice, 10)
    bob, _, bob_sk = state.sample_keys_and_register(pp, rng)
    registered = state.root()
    verdicts = {}
    tx = Transaction.create(pp, alice, bob, 5, alice_sk, rng)
    verdicts["transfer_validate"] = tx.validate(pp, state, rng)
    verdicts["transfer_apply"] = state.apply_transaction(pp, tx, rng) is True
    transferred = state.root()
    for name, (amount, to, sk) in {"overspend": (6, bob, alice_sk),
                                   "forged_signature": (5, bob, bob_sk),
                                   "unknown_recipient": (5, AccountId(10), alice_sk)}.items():
        verdicts[name] = Transaction.create(pp, alice, to, amount, sk, rng).validate(pp, state, rng)
    return {"accounts": 32, "ids": [alice.value, bob.value], "verdicts": verdicts,
            "balances": {"alice": state.id_to_account_info[alice].balance,
                         "bob": state.id_to_account_info[bob].balance},
            "roots": {"registered": hex(registered), "transferred": hex(transferred),
                      "final": hex(state.root())}}


def reference_results() -> dict:
    """Both workloads' reference results, as the fixture file holds them.
    Run with REFERENCE_ENV set."""
    return {"merkle": reference_merkle(),
            "payments": reference_payments()}


def test_fixture_is_well_formed():
    ref = json.loads(FIXTURE.read_text())
    merkle, payments = ref["merkle"], ref["payments"]
    assert merkle["leaves"] == LEAVES and tuple(merkle["srs_sizes"]) == SRS_SIZES
    assert merkle["leaf_window"] == [4, 144] and merkle["two_to_one_window"] == [4, 128]
    assert merkle["num_constraints"] == NUM_CONSTRAINTS
    for key in ("verifying_key", "proof"):
        data = bytes.fromhex(merkle[key]["hex"])
        assert len(data) == merkle[key]["bytes"]
        assert hashlib.sha256(data).hexdigest() == merkle[key]["sha256"]
    assert merkle["proof"]["bytes"] == PROOF_BYTES
    assert list(payments["verdicts"]) == VERDICTS
    assert list(payments["verdicts"].values()) == [True, True, False, False, False]
    assert payments["balances"] == {"alice": 5, "bob": 5} and payments["ids"] == [1, 2]
    roots = payments["roots"]
    assert roots["transferred"] == roots["final"] != roots["registered"]


@pytest.mark.slow
@pytest.mark.fullscale
def test_fixture_matches_reference(monkeypatch):
    for key, value in REFERENCE_ENV.items():
        monkeypatch.setenv(key, value)
    assert reference_results() == json.loads(FIXTURE.read_text())


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_merkle_fixture.py --write")
    sys.path.insert(0, str(FIXTURE.parents[2]))  # the repo root, for simpleworks_tpu
    os.environ.update(REFERENCE_ENV)
    FIXTURE.parent.mkdir(exist_ok=True)
    FIXTURE.write_text(json.dumps(reference_results(), indent=1) + "\n")
    print(f"wrote {FIXTURE}")

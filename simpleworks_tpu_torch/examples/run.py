"""Runnable demo driver for the reference workloads on the port.

The reference exposes its examples as ``cargo run --example NAME``
(reference README.md:12-16, Cargo.toml:50-60); this module is the
equivalent::

    python -m simpleworks_tpu_torch.examples.run                 # all five, demo scale
    python -m simpleworks_tpu_torch.examples.run merkle-tree     # one workload
    python -m simpleworks_tpu_torch.examples.run --full merkle-tree simple-payments

Demo scale keeps every workload small (small SRS, reduced Pedersen leaf
window); ``--full`` switches to the exact reference parameters —
SRS(100_000, 25_000, 300_000), Pedersen windows 4x144 / 4x128
(reference src/merkle_tree/simple_merkle_tree.rs:39, common.rs:16-30).
The SRS, index and prove of every workload run on the card; without one the
driver raises (it does not fall back to the CPU).  Every step prints its
seconds.

Port of ``simpleworks_tpu/examples/run.py``, without its ``proof-pipeline``
workload (the parallel planes are not ported).
"""

from __future__ import annotations

import argparse
import sys
import time
from contextlib import contextmanager


#: the leaf the merkle-tree workload checks is not in the tree
ABSENT_LEAF = 77
#: the simple-payments sequence's verdict at each step
PAYMENTS_VERDICTS = {"transfer_validate": True, "transfer_apply": True, "overspend": False,
                     "forged_signature": False, "unknown_recipient": False}


def _write(text: str) -> None:
    sys.stdout.write(text)
    sys.stdout.flush()


@contextmanager
def _step(label: str):
    _write(f"  {label} ...")
    start = time.perf_counter()
    yield
    _write(f" ok ({time.perf_counter() - start:.2f}s)\n")


def _cli_step(_key: str, label: str, fn):
    """A sequence's step as the CLI runs it: its label, then its seconds."""
    with _step(label):
        return fn()


def _expect(what: str, got, want) -> None:
    if got != want:
        raise AssertionError(f"{what}: {got}, expected {want}")


def run_test_circuit(full: bool) -> None:
    """reference examples/test-circuit.rs: satisfiability pair + Marlin
    round-trip at SRS(100, 25, 300) (test-circuit.rs:35-81)."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.examples.test_circuit import synthesize

    with _step("satisfiability (a == b)"):
        assert synthesize(87, 87).is_satisfied()
    with _step("unsatisfiability (a != b)"):
        assert not synthesize(87, 88).is_satisfied()
    cs = synthesize(87, 87)
    with _step("universal_setup(100, 25, 300)"):
        srs = marlin.universal_setup(100, 25, 300, marlin.generate_rand())
    with _step("index + prove + verify"):
        pk, vk = marlin.index(srs, cs)
        proof = marlin.prove(pk, cs)
        assert marlin.verify(vk, [], proof)


def run_manual_constraints(full: bool) -> None:
    """reference examples/manual-constraints.rs: raw R1CS equality circuit,
    public input [number] (manual-constraints.rs:87-100)."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.examples.manual_constraints import synthesize

    number = 86
    with _step("satisfiability"):
        assert synthesize(number, number).is_satisfied()
    with _step("unsatisfiability"):
        assert not synthesize(number, number + 1).is_satisfied()
    cs = synthesize(number, number)
    with _step("universal_setup(100, 25, 300)"):
        srs = marlin.universal_setup(100, 25, 300, marlin.generate_rand())
    with _step("index + prove + verify(public=[number])"):
        pk, vk = marlin.index(srs, cs)
        proof = marlin.prove(pk, cs)
        assert marlin.verify(vk, [number], proof)


def merkle_tree_sequence(step, leaves, absent: int = ABSENT_LEAF, **tree_kwargs) -> dict:
    """The merkle-tree workload (reference examples/merkle-tree/main.rs:102-258):
    build the self-proving tree (``SimpleMerkleTree(leaves, **tree_kwargs)``:
    Pedersen parameters, the trees, the SRS and the index), check the
    membership of ``leaves[0]`` and of ``absent``, prove ``leaves[0]``'s
    membership, verify the proof for it and for ``absent``.

    Each step runs as ``step(key, label, fn)``, which returns ``fn()``: the
    CLI prints the label and the seconds, ``chip_smoke.py`` times it under
    the key.  Raises AssertionError on a wrong result; returns the tree, the
    path of leaf 0 and the proof's bytes."""
    from simpleworks_tpu_torch.merkle.simple_merkle_tree import (
        SimpleMerkleTree,
        check_leave_exists_u8,
    )

    leaf = leaves[0]
    tree = step("build", f"SimpleMerkleTree({len(leaves)} leaves): SRS + index",
                lambda: SimpleMerkleTree(leaves, **tree_kwargs))
    path = tree.get_merkle_path(0)
    exists = step("check_leave_exists", f"membership satisfiability (leaf {leaf}, then {absent})",
                  lambda: (check_leave_exists_u8(tree, leaf, path),
                           check_leave_exists_u8(tree, absent, path)))
    _expect(f"check_leave_exists_u8 for leaf {leaf} and {absent}", exists, (True, False))
    proof = step("prove", "prove membership (Marlin)", lambda: tree.prove(leaf, path))
    _expect(f"verify for leaf {leaf}",
            step("verify", f"verify ({len(proof)}-byte proof)", lambda: tree.verify(proof, leaf)),
            True)
    _expect(f"verify for leaf {absent}",
            step("verify_absent", "reject proof against wrong leaf",
                 lambda: tree.verify(proof, absent)),
            False)
    return {"tree": tree, "path": path, "proof": proof}


def run_merkle_tree(full: bool) -> None:
    """reference examples/merkle-tree/main.rs: 8-leaf Pedersen tree,
    membership satisfiability pair, then the self-proving tree's full
    Marlin round-trip (main.rs:102-258)."""
    from simpleworks_tpu_torch.examples.merkle_tree import EXAMPLE_LEAVES
    from simpleworks_tpu_torch.hash.pedersen import PedersenWindow

    if full:
        merkle_tree_sequence(_cli_step, EXAMPLE_LEAVES)
    else:
        merkle_tree_sequence(
            _cli_step,
            [1, 2],
            srs_scale=(8_192, 8_192, 40_000),
            leaf_window=PedersenWindow(window_size=4, num_windows=4),
            two_to_one_window=PedersenWindow(window_size=4, num_windows=128),
        )


def run_schnorr_signature(full: bool) -> None:
    """reference examples/schnorr-signature/main.rs: native sign/verify,
    in-circuit satisfiability pair, and (--full) the Marlin round-trip at
    SRS(100k, 25k, 300k) with empty public inputs (main.rs:79-209)."""
    from simpleworks_tpu_torch.examples.schnorr_circuit import synthesize
    from simpleworks_tpu_torch.schnorr import schnorr
    from simpleworks_tpu_torch.utils.rng import test_rng

    rng = test_rng()
    params = schnorr.setup(rng)
    pk_s, sk = schnorr.keygen(params, rng)
    message = b"a message to sign"
    with _step("native sign + verify"):
        sig = schnorr.sign(params, sk, message, rng)
        assert schnorr.verify(params, pk_s, message, sig)
    with _step("native verify rejects wrong message"):
        assert not schnorr.verify(params, pk_s, b"another message", sig)
    with _step("in-circuit verify satisfiability"):
        cs = synthesize(params, pk_s, message, sig)
        assert cs.is_satisfied()
        _write(f" [{cs.num_constraints} constraints]")
    with _step("in-circuit unsatisfiability (wrong message)"):
        assert not synthesize(params, pk_s, b"another message", sig).is_satisfied()
    if full:
        from simpleworks_tpu_torch import marlin

        with _step("universal_setup(100k, 25k, 300k)"):
            srs = marlin.universal_setup(
                100_000, 25_000, 300_000, marlin.generate_rand()
            )
        with _step("index + prove + verify (empty public inputs)"):
            pk, vk = marlin.index(srs, cs)
            proof = marlin.prove(pk, cs)
            assert marlin.verify(vk, [], proof)
    else:
        _write("  (Marlin round-trip at reference scale: re-run with --full)\n")


def simple_payments_sequence(step, prove_transactions: bool, device=None) -> dict:
    """The simple-payments workload (reference examples/simple-payments/
    ledger.rs:202-250): a 32-account ledger from ``test_rng()``; register
    alice with balance 10, then bob; a transfer of 5 (validate, then apply),
    an overspend of 6, a signature made with bob's key and an unknown
    recipient.  With ``prove_transactions`` every validate whose native
    signature check passes runs the per-transaction Marlin pipeline
    (transaction.rs:89-139) on ``device``.

    Each step runs as ``step(key, label, fn)``, as in
    :func:`merkle_tree_sequence`.  Raises AssertionError on a wrong result;
    returns the verdicts by step, the final balances and the account tree's
    roots after registration, after the transfer and at the end."""
    from simpleworks_tpu_torch.examples.simple_payments.account import AccountId
    from simpleworks_tpu_torch.examples.simple_payments.ledger import Parameters, State
    from simpleworks_tpu_torch.examples.simple_payments.transaction import Transaction
    from simpleworks_tpu_torch.utils.rng import test_rng

    rng = test_rng()
    pp = step("sample", f"Parameters.sample(prove_transactions={prove_transactions})",
              lambda: Parameters.sample(rng, prove_transactions=prove_transactions, device=device))
    state = State(32, pp)

    def register():
        alice, _, alice_sk = state.sample_keys_and_register(pp, rng)
        _expect("alice's balance update", state.update_balance(alice, 10), True)
        bob, _, bob_sk = state.sample_keys_and_register(pp, rng)
        return alice, alice_sk, bob, bob_sk

    alice, alice_sk, bob, bob_sk = step("register", "register alice (balance 10) + bob", register)
    _expect("alice's id", alice, AccountId(1))
    roots = {"registered": hex(state.root())}
    tx = Transaction.create(pp, alice, bob, 5, alice_sk, rng)
    verdicts = {
        "transfer_validate": step("transfer_validate", "validate transfer alice->bob of 5",
                                  lambda: tx.validate(pp, state, rng)),
        "transfer_apply": step("transfer_apply", "apply it",
                               lambda: state.apply_transaction(pp, tx, rng) is True),
    }
    roots["transferred"] = hex(state.root())
    for key, label, amount, to, sk in (
        ("overspend", "reject overspend (6 > 5)", 6, bob, alice_sk),
        ("forged_signature", "reject wrong signature (signed with bob's key)", 5, bob, bob_sk),
        ("unknown_recipient", "reject unknown recipient", 5, AccountId(10), alice_sk),
    ):
        bad = Transaction.create(pp, alice, to, amount, sk, rng)
        verdicts[key] = step(key, label, lambda: bad.validate(pp, state, rng))
    roots["final"] = hex(state.root())
    balances = {"alice": state.id_to_account_info[alice].balance,
                "bob": state.id_to_account_info[bob].balance}
    _expect("verdicts", verdicts, PAYMENTS_VERDICTS)
    _expect("balances", balances, {"alice": 5, "bob": 5})
    return {"verdicts": verdicts, "balances": balances, "roots": roots}


def run_simple_payments(full: bool) -> None:
    """reference examples/simple-payments/ledger.rs:202-250: 32-account
    ledger, register two accounts, one valid + three invalid transactions.
    With --full every validate() runs the reference's per-transaction
    Marlin pipeline (transaction.rs:89-139)."""
    simple_payments_sequence(_cli_step, prove_transactions=full)


WORKLOADS = {
    "test-circuit": run_test_circuit,
    "manual-constraints": run_manual_constraints,
    "merkle-tree": run_merkle_tree,
    "schnorr-signature": run_schnorr_signature,
    "simple-payments": run_simple_payments,
}


def main(argv: list[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m simpleworks_tpu_torch.examples.run",
        description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter,
    )
    parser.add_argument(
        "workloads",
        nargs="*",
        metavar="WORKLOAD",
        help=f"workloads to run (default: all): {', '.join(WORKLOADS)}",
    )
    parser.add_argument(
        "--full",
        action="store_true",
        help="use the exact reference parameters",
    )
    args = parser.parse_args(argv)
    for name in args.workloads:
        if name not in WORKLOADS:
            parser.error(
                f"unknown workload {name!r} (choose from {', '.join(WORKLOADS)})"
            )
    names = args.workloads or list(WORKLOADS)
    for name in names:
        _write(f"[{name}]\n")
        start = time.perf_counter()
        WORKLOADS[name](args.full)
        _write(f"  done in {time.perf_counter() - start:.2f}s\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

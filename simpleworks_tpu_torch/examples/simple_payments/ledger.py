"""The simple-payments account ledger
(reference ``examples/simple-payments/ledger.rs``).

State = blank Merkle tree of height log2(num_accounts) + id→info and
pubkey→id maps; sequential AccountId registration starting at 1;
``apply_transaction`` = validate → debit/credit via incremental tree
updates.

Pedersen windows here are the reference's *transposed* shapes
(ledger.rs:60-74: two-to-one 128×4, leaf 144×4 — same capacities as the
library's 4×128 / 4×144).

``validate_block`` is the ledger's batched form over the parallel planes:
one satisfiability batch for the whole block, then, with ``prove=True``, a
pipelined Marlin proof of each transaction that passed.

Port of ``simpleworks_tpu/examples/simple_payments/ledger.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

from ...curves.edwards import EdwardsPoint
from ...hash.pedersen import PedersenWindow, pedersen_setup
from ...merkle.tree import MerkleTree
from ...schnorr import schnorr
from .account import AccountId, AccountInformation
from ...config import DEFAULT_CONFIG

#: reference ledger.rs:60-63
TWO_TO_ONE_WINDOW = PedersenWindow(window_size=128, num_windows=4)
#: reference ledger.rs:71-74
LEAF_WINDOW = PedersenWindow(window_size=144, num_windows=4)

MAX_AMOUNT = (1 << 64) - 1


@dataclass
class Parameters:
    """reference ledger.rs:33-52."""

    sig_params: schnorr.SchnorrParameters
    leaf_crh_params: object
    two_to_one_crh_params: object
    #: Marlin SRS scale used per-transaction (reference transaction.rs:96)
    srs_scale: tuple[int, int, int] = DEFAULT_CONFIG.large_srs
    #: run the full Marlin prove/verify inside Transaction::validate
    prove_transactions: bool = True
    #: where that Marlin leg's SRS, index and prove run: the card unless the
    #: caller names another device (``"cpu"``)
    device: object = None

    @staticmethod
    def sample(rng, leaf_window=LEAF_WINDOW, two_to_one_window=TWO_TO_ONE_WINDOW,
               srs_scale=DEFAULT_CONFIG.large_srs, prove_transactions=True, device=None):
        sig_params = schnorr.setup(rng)
        leaf_crh_params = pedersen_setup(leaf_window, rng)
        two_to_one_crh_params = pedersen_setup(two_to_one_window, rng)
        return Parameters(
            sig_params=sig_params,
            leaf_crh_params=leaf_crh_params,
            two_to_one_crh_params=two_to_one_crh_params,
            srs_scale=srs_scale,
            prove_transactions=prove_transactions,
            device=device,
        )


class State:
    """reference ledger.rs:90-194."""

    def __init__(self, num_accounts: int, parameters: Parameters):
        # reference ledger.rs:106: height = ark_std::log2(num_accounts) (ceil)
        height = max(2, (num_accounts - 1).bit_length())
        self.parameters = parameters
        self.account_merkle_tree = MerkleTree.blank(
            parameters.leaf_crh_params, parameters.two_to_one_crh_params, height
        )
        self.next_available_account: Optional[AccountId] = AccountId(1)
        self.id_to_account_info: dict[AccountId, AccountInformation] = {}
        self.pub_key_to_id: dict[EdwardsPoint, AccountId] = {}

    def root(self) -> int:
        return self.account_merkle_tree.root()

    def register(self, public_key: EdwardsPoint) -> Optional[AccountId]:
        """reference ledger.rs:131-150."""
        if self.next_available_account is None:
            return None
        acc_id = self.next_available_account
        if acc_id.value >= len(self.account_merkle_tree.levels[0]):
            return None
        info = AccountInformation(public_key=public_key, balance=0)
        self.pub_key_to_id[public_key] = acc_id
        self.account_merkle_tree.update(acc_id.value, info.to_bytes_le())
        self.id_to_account_info[acc_id] = info
        self.next_available_account = acc_id.checked_increment()
        return acc_id

    def sample_keys_and_register(self, ledger_params: Parameters, rng):
        """reference ledger.rs:153-161."""
        pub_key, secret_key = schnorr.keygen(ledger_params.sig_params, rng)
        acc_id = self.register(pub_key)
        if acc_id is None:
            return None
        return acc_id, pub_key, secret_key

    def update_balance(self, acc_id: AccountId, new_amount: int) -> Optional[bool]:
        """reference ledger.rs:166-173."""
        info = self.id_to_account_info.get(acc_id)
        if info is None:
            return None
        info.balance = new_amount
        self.account_merkle_tree.update(acc_id.value, info.to_bytes_le())
        return True

    def validate_block(self, pp: Parameters, txs, devices=None, prove: bool = False,
                       rng=None, max_in_flight: int = 3):
        """Validate a block of transactions at once (the reference validates
        one at a time, ledger.rs:176-193).  Does not mutate the state.

        On the host, each transaction's stateless checks (the sender exists,
        its Merkle path, the balance, the recipient exists) and the native
        Schnorr verify, as ``Transaction.verify_signature`` runs them.  Then
        one schnorr circuit is synthesised a transaction whose sender
        exists, and the in-circuit verification of all of them runs as one
        satisfiability batch over ``devices`` (``sharded_check_host``; the
        cards of ``default_devices()`` by default, so without a card this
        raises unless the caller passes CPU devices).  The batch checks
        every row against the first circuit's matrices, as the reference
        does: the public key, message and signature are all witnesses, so
        every transaction's circuit has one structure, and only the
        assignments differ.

        With ``prove=True``, one SRS at ``pp.srs_scale`` (``rng`` or
        ``test_rng()``, on ``pp.device``) and a pipelined index and prove
        (``prove_indexed_stream``, each proof's randomness a fresh
        ``test_rng()``) of each transaction that passed; a proof that fails
        its verify fails the transaction.  Returns the verdicts, or with
        ``prove=True`` ``(verdicts, proof_bytes)``, ``proof_bytes[i]`` the
        serialized proof or None."""
        from ...fields.bls12_377 import ConstraintF
        from ...parallel import default_devices
        from ...parallel.witness_dp import sharded_check_host
        from ...r1cs.constraint_system import ConstraintSystem
        from ..schnorr_circuit import SimpleSchnorrSignatureVerification
        from .transaction import Transaction

        if devices is None:
            devices = default_devices()
        verdicts: list[bool] = []
        rows: list[int] = []  # the transaction of each batched assignment
        circuits = []
        for i, tx in enumerate(txs):
            sender_info = self.id_to_account_info.get(tx.sender)
            if sender_info is None:
                verdicts.append(False)
                continue
            path = self.account_merkle_tree.generate_proof(tx.sender.value)
            ok = path.verify(pp.leaf_crh_params, pp.two_to_one_crh_params,
                             self.account_merkle_tree.root(), sender_info.to_bytes_le())
            message = Transaction._message(tx.sender, tx.recipient, tx.amount)
            ok &= schnorr.verify(pp.sig_params, sender_info.public_key, message, tx.signature)
            ok &= tx.amount <= sender_info.balance
            ok &= self.id_to_account_info.get(tx.recipient) is not None
            verdicts.append(bool(ok))
            cs = ConstraintSystem(ConstraintF)
            SimpleSchnorrSignatureVerification(
                parameters=pp.sig_params,
                public_key=sender_info.public_key,
                message=message,
                signature=tx.signature,
            ).generate_constraints(cs)
            rows.append(i)
            circuits.append(cs)

        if circuits:
            sat = sharded_check_host(devices, circuits[0], [cs.full_assignment() for cs in circuits])
            for row, ok in zip(rows, sat):
                verdicts[row] = verdicts[row] and ok
        if not prove:
            return verdicts

        from ... import marlin
        from ...marlin.serialization import serialize_proof
        from ...parallel.proof_pipeline import prove_indexed_stream
        from ...utils.rng import test_rng

        srs = marlin.universal_setup(*pp.srs_scale, rng or test_rng(), device=pp.device)
        to_prove = [(row, cs) for row, cs in zip(rows, circuits) if verdicts[row]]
        proofs: list[Optional[bytes]] = [None] * len(txs)
        results = prove_indexed_stream(srs, [cs for _, cs in to_prove],
                                       max_in_flight=max_in_flight)
        for (row, _cs), (proof, ok) in zip(to_prove, results):
            verdicts[row] = verdicts[row] and ok
            proofs[row] = serialize_proof(proof) if ok else None
        return verdicts, proofs

    def apply_transaction(self, pp: Parameters, tx, rng) -> Optional[bool]:
        """reference ledger.rs:176-193."""
        if not tx.validate(pp, self, rng):
            return None
        old_sender = self.id_to_account_info[tx.sender].balance
        old_recipient = self.id_to_account_info[tx.recipient].balance
        new_sender = old_sender - tx.amount
        new_recipient = old_recipient + tx.amount
        if new_sender < 0 or new_recipient > MAX_AMOUNT:
            return None
        self.update_balance(tx.sender, new_sender)
        self.update_balance(tx.recipient, new_recipient)
        return True

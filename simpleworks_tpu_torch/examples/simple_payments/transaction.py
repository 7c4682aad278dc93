"""Transactions for the simple-payments ledger
(reference ``examples/simple-payments/transaction.rs``).

``validate`` replicates the reference's four checks (transaction.rs:148-185):
Merkle membership of the sender's account, signature verification — which
runs the **whole Marlin pipeline per call** (fresh SRS + index + prove +
verify, transaction.rs:89-139) plus a native Schnorr verify — a balance
check and a recipient-exists check.

``Parameters.prove_transactions`` gates the Marlin leg so CPU test runs can
exercise the ledger semantics at tractable cost; the full pipeline runs on
``Parameters.device``, the card by default.

Port of ``simpleworks_tpu/examples/simple_payments/transaction.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from ... import marlin
from ...fields.bls12_377 import ConstraintF
from ...r1cs.constraint_system import ConstraintSystem
from ...schnorr import schnorr
from ...utils.rng import test_rng
from ..schnorr_circuit import SimpleSchnorrSignatureVerification
from .account import AccountId
from .ledger import Parameters, State


@dataclass
class Transaction:
    sender: AccountId
    recipient: AccountId
    amount: int
    signature: schnorr.SchnorrSignature

    @staticmethod
    def create(parameters: Parameters, sender: AccountId, recipient: AccountId,
               amount: int, sender_sk: schnorr.SchnorrSecretKey, rng) -> "Transaction":
        """reference transaction.rs:188-207: message =
        sender ‖ recipient ‖ amount (LE bytes)."""
        message = Transaction._message(sender, recipient, amount)
        signature = schnorr.sign(parameters.sig_params, sender_sk, message, rng)
        return Transaction(sender=sender, recipient=recipient, amount=amount,
                           signature=signature)

    @staticmethod
    def _message(sender: AccountId, recipient: AccountId, amount: int) -> bytes:
        return sender.to_bytes_le() + recipient.to_bytes_le() + amount.to_bytes(8, "little")

    def verify_signature(self, pp: Parameters, pub_key, rng) -> bool:
        """reference transaction.rs:89-139: native Schnorr verify AND a full
        Marlin proof of the Schnorr circuit (fresh SRS per call)."""
        message = Transaction._message(self.sender, self.recipient, self.amount)
        schnorr_ok = schnorr.verify(pp.sig_params, pub_key, message, self.signature)
        if not pp.prove_transactions:
            return schnorr_ok
        if not schnorr_ok:
            # the reference would fail at proving time (unsatisfiable circuit);
            # short-circuit with the same outcome
            return False
        srs = marlin.universal_setup(*pp.srs_scale, rng, device=pp.device)
        cs = ConstraintSystem(ConstraintF)
        SimpleSchnorrSignatureVerification(
            parameters=pp.sig_params,
            public_key=pub_key,
            message=message,
            signature=self.signature,
        ).generate_constraints(cs)
        index_pk, index_vk = marlin.index(srs, cs)
        proof = marlin.prove(index_pk, cs, rng)
        marlin_ok = marlin.verify(index_vk, [], proof, rng)
        return schnorr_ok and marlin_ok

    def validate(self, parameters: Parameters, state: State, rng=None) -> bool:
        """reference transaction.rs:148-185."""
        rng = rng or test_rng()
        sender_info = state.id_to_account_info.get(self.sender)
        if sender_info is None:
            return False
        result = True
        path = state.account_merkle_tree.generate_proof(self.sender.value)
        result &= path.verify(
            parameters.leaf_crh_params,
            parameters.two_to_one_crh_params,
            state.account_merkle_tree.root(),
            sender_info.to_bytes_le(),
        )
        result &= self.verify_signature(parameters, sender_info.public_key, rng)
        result &= self.amount <= sender_info.balance
        result &= state.id_to_account_info.get(self.recipient) is not None
        return bool(result)

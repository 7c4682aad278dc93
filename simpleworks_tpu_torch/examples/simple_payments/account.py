"""Accounts for the simple-payments ledger
(reference ``examples/simple-payments/account.rs``).

Port of ``simpleworks_tpu/examples/simple_payments/account.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass

from ...curves.edwards import EdwardsPoint


@dataclass(frozen=True)
class AccountId:
    """u8 identifier — the prototype supports 256 accounts (account.rs:11-12)."""

    value: int

    def to_bytes_le(self) -> bytes:
        return bytes([self.value])

    def checked_increment(self):
        return AccountId(self.value + 1) if self.value < 255 else None


@dataclass
class AccountInformation:
    """Public key + balance, serialized as the Merkle leaf
    (account.rs:29-42: ToBytes = pubkey x‖y raw ‖ balance u64 LE)."""

    public_key: EdwardsPoint
    balance: int  # Amount(u64)

    def to_bytes_le(self) -> bytes:
        return self.public_key.to_bytes_raw() + self.balance.to_bytes(8, "little")

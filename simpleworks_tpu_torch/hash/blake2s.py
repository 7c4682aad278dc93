"""Native Blake2s-256 (RFC 7693), the reference's random oracle and
Fiat-Shamir hash (reference ``src/schnorr_signature/blake2s.rs:53-59``,
``src/marlin/mod.rs:13``; blake2 crate v0.9 unkeyed Blake2s == hashlib's).
"""

from __future__ import annotations

import hashlib


def blake2s_digest(data: bytes) -> bytes:
    """32-byte Blake2s-256 digest."""
    return hashlib.blake2s(data).digest()

"""Square roots in BLS12-377 Fq (helper for point decompression and G2)."""

from __future__ import annotations

from ..fields.bls12_377 import Fq


def fq_sqrt(a: int):
    """Tonelli-Shanks in Fq; None for non-residues."""
    root = Fq(a).sqrt()
    return None if root is None else root.value

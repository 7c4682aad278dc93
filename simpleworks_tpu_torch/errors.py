"""Typed errors + the ``ensure`` guard.

The reference wraps every fallible boundary in ``anyhow::Result`` with a
literal message and uses ``ensure!`` for native-side guards (e.g.
``src/marlin/mod.rs:42-44``, ``src/gadgets/uint8.rs:277,305``).  The
framework equivalent: raise :class:`SimpleworksError` via :func:`ensure` —
unlike ``assert``, these survive ``python -O`` (soundness-relevant checks
such as KZG degree bounds and sumcheck remainders must never be compiled
out).
"""

from __future__ import annotations


class SimpleworksError(ValueError):
    """Base error for library-path failures (degree bounds, unsatisfied
    sumchecks, malformed inputs)."""


def ensure(condition: bool, message: str) -> None:
    """Raise :class:`SimpleworksError` when ``condition`` is false
    (the reference's ``ensure!``; active under ``python -O``)."""
    if not condition:
        raise SimpleworksError(message)

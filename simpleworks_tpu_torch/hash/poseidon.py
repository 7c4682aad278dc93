"""Poseidon sponge hash over ConstraintF — native and in-circuit.

Replaces ``ark_sponge::poseidon`` (SURVEY.md §2.3 'Poseidon sponge') with the
exact parameters hard-coded in reference ``src/hash/helpers.rs``: width 3
(rate 2 + capacity 1), α = 17, 8 full + 29 partial rounds, 3×3 MDS, 37×3
round constants (decimal strings reduced mod Fr; stored in
``poseidon_params.json``).

The permutation and duplex-sponge schedule are shared between the native and
gadget paths through a small ops adapter, so the reference's own acceptance
test — gadget output == native output (``src/gadgets/poseidon.rs:43-54``) —
holds by construction.

Byte absorption packs LE 31-byte chunks into field elements (arkworks
``ToConstraintField<[u8]>`` convention), matching both the native
``absorb(&[u8])`` and the gadget ``UInt8`` path.

Round schedule: capacity element at state[0]; partial-round S-box applies to
state[0]; rounds ordered full/2, partial, full/2 (ark-sponge 0.3 layout).

Port of ``simpleworks_tpu/hash/poseidon.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path

from ..fields.bls12_377 import ConstraintF
from ..errors import ensure

_PARAMS_PATH = Path(__file__).parent / "poseidon_params.json"


@lru_cache(maxsize=None)
def poseidon_parameters():
    """Parsed parameters with constants reduced into ConstraintF."""
    raw = json.loads(_PARAMS_PATH.read_text())
    p = ConstraintF.PARAMS.modulus
    return {
        "alpha": raw["alpha"],
        "full_rounds": raw["full_rounds"],
        "partial_rounds": raw["partial_rounds"],
        "rate": raw["rate"],
        "capacity": raw["capacity"],
        "mds": [[int(c) % p for c in row] for row in raw["mds"]],
        "ark": [[int(c) % p for c in row] for row in raw["ark"]],
    }


class _NativeOps:
    """Field ops over plain ints mod p (host path)."""

    def __init__(self):
        self.p = ConstraintF.PARAMS.modulus

    def zero(self):
        return 0

    def add(self, a, b):
        return (a + b) % self.p

    def add_constant(self, a, c):
        return (a + c) % self.p

    def mul_constant(self, a, c):
        return a * c % self.p

    def pow_alpha(self, a, alpha):
        return pow(a, alpha, self.p)


class _GadgetOps:
    """Field ops over FieldVar (in-circuit path)."""

    def __init__(self, cs):
        from ..gadgets.field_var import FieldVar

        self.cs = cs
        self.FieldVar = FieldVar

    def zero(self):
        return self.FieldVar.constant(self.cs, 0)

    def add(self, a, b):
        return a.add(b)

    def add_constant(self, a, c):
        return a.add(self.FieldVar.constant(self.cs, c))

    def mul_constant(self, a, c):
        return a.mul_by_constant(c)

    def pow_alpha(self, a, alpha):
        return a.pow_by_constant(alpha)


class PoseidonSponge:
    """Duplex sponge; ``ops`` selects native vs gadget element type."""

    def __init__(self, ops=None):
        self.params = poseidon_parameters()
        self.ops = ops or _NativeOps()
        width = self.params["rate"] + self.params["capacity"]
        self.state = [self.ops.zero() for _ in range(width)]
        self.mode = ("absorbing", 0)  # (phase, next index within rate)

    # -- permutation ---------------------------------------------------------

    def _apply_ark(self, round_idx: int) -> None:
        ark = self.params["ark"][round_idx]
        self.state = [
            self.ops.add_constant(elem, ark[i]) for i, elem in enumerate(self.state)
        ]

    def _apply_sbox(self, is_full: bool) -> None:
        alpha = self.params["alpha"]
        if is_full:
            self.state = [self.ops.pow_alpha(e, alpha) for e in self.state]
        else:
            self.state[0] = self.ops.pow_alpha(self.state[0], alpha)

    def _apply_mds(self) -> None:
        mds = self.params["mds"]
        new_state = []
        for i in range(len(self.state)):
            acc = self.ops.zero()
            for j, elem in enumerate(self.state):
                acc = self.ops.add(acc, self.ops.mul_constant(elem, mds[i][j]))
            new_state.append(acc)
        self.state = new_state

    def permute(self) -> None:
        full, partial = self.params["full_rounds"], self.params["partial_rounds"]
        half_full = full // 2
        r = 0
        for _ in range(half_full):
            self._apply_ark(r)
            self._apply_sbox(True)
            self._apply_mds()
            r += 1
        for _ in range(partial):
            self._apply_ark(r)
            self._apply_sbox(False)
            self._apply_mds()
            r += 1
        for _ in range(half_full):
            self._apply_ark(r)
            self._apply_sbox(True)
            self._apply_mds()
            r += 1

    # -- duplex schedule -------------------------------------------------------

    def absorb_elements(self, elements) -> None:
        if not elements:
            return
        rate, capacity = self.params["rate"], self.params["capacity"]
        phase, idx = self.mode
        if phase == "squeezing" or idx == rate:
            if phase == "absorbing" and idx == rate:
                self.permute()
            idx = 0
            if phase == "squeezing":
                self.permute()
                idx = 0
        remaining = list(elements)
        while remaining:
            space = rate - idx
            chunk, remaining = remaining[:space], remaining[space:]
            for i, elem in enumerate(chunk):
                self.state[capacity + idx + i] = self.ops.add(
                    self.state[capacity + idx + i], elem
                )
            idx += len(chunk)
            if remaining:
                self.permute()
                idx = 0
        self.mode = ("absorbing", idx)

    def squeeze_elements(self, n: int) -> list:
        rate, capacity = self.params["rate"], self.params["capacity"]
        phase, idx = self.mode
        if phase == "absorbing":
            self.permute()
            idx = 0
        out = []
        while len(out) < n:
            if idx == rate:
                self.permute()
                idx = 0
            out.append(self.state[capacity + idx])
            idx += 1
        self.mode = ("squeezing", idx)
        return out


def bytes_to_field_elements(data: bytes) -> list[int]:
    """arkworks ``ToConstraintField<[u8]>``: LE 31-byte chunks -> Fr ints."""
    capacity_bytes = (ConstraintF.PARAMS.modulus_bits - 1) // 8
    return [
        int.from_bytes(data[i : i + capacity_bytes], "little")
        for i in range(0, len(data), capacity_bytes)
    ]


def poseidon2_hash(data: bytes) -> int:
    """Native hash: absorb bytes, squeeze one Fr element
    (reference src/hash/mod.rs:32-43)."""
    sponge = PoseidonSponge()
    sponge.absorb_elements(bytes_to_field_elements(data))
    return sponge.squeeze_elements(1)[0]


def poseidon2_hash_gadget(input_bytes):
    """In-circuit hash of a UInt8 vector; returns a FieldVar
    (reference src/gadgets/poseidon.rs:12-31)."""
    from ..gadgets.field_var import FieldVar

    ensure(bool(input_bytes), "empty input")
    cs = next(b.cs for b in input_bytes if b.cs is not None)
    capacity_bytes = (ConstraintF.PARAMS.modulus_bits - 1) // 8
    # pack byte gadgets into field vars (31-byte LE chunks): sum b_i * 256^i
    elements = []
    p = ConstraintF.PARAMS.modulus
    for off in range(0, len(input_bytes), capacity_bytes):
        chunk = input_bytes[off : off + capacity_bytes]
        acc = FieldVar.constant(cs, 0)
        for i, byte_gadget in enumerate(chunk):
            byte_fv = _uint8_to_field_var(cs, byte_gadget)
            acc = acc.add(byte_fv.mul_by_constant(pow(256, i, p)))
        elements.append(acc)
    sponge = PoseidonSponge(ops=_GadgetOps(cs))
    sponge.absorb_elements(elements)
    return sponge.squeeze_elements(1)[0]


def _uint8_to_field_var(cs, byte_gadget):
    """UInt8 -> FieldVar via its bit LCs (no new constraints)."""
    from ..gadgets.field_var import FieldVar

    lc = cs.lc()
    for i, bit in enumerate(byte_gadget.bits):
        lc = lc + bit.lc() * (1 << i)
    return FieldVar(cs, lc, byte_gadget.value())


# -- general absorb surface (reference ark-sponge ``Absorb`` /
#    ``AbsorbGadget``: src/gadgets/poseidon.rs:12-31 absorbs any
#    AbsorbGadget via to_sponge_bytes; natives absorb field elements) --


def absorb(sponge: "PoseidonSponge", value) -> None:
    """Absorb any supported value: bytes (LE 31-byte chunks), a field
    element (int), an Edwards point (affine coordinates), or a nested
    list/tuple of those."""
    from ..curves.edwards import EdwardsPoint

    if isinstance(value, (bytes, bytearray)):
        sponge.absorb_elements(bytes_to_field_elements(bytes(value)))
    elif isinstance(value, bool):
        sponge.absorb_elements([int(value)])
    elif isinstance(value, int):
        sponge.absorb_elements([value % ConstraintF.PARAMS.modulus])
    elif isinstance(value, EdwardsPoint):
        x, y = value.to_affine()
        sponge.absorb_elements([x, y])
    elif isinstance(value, (list, tuple)):
        for v in value:
            absorb(sponge, v)
    else:
        raise TypeError(f"cannot absorb {type(value).__name__}")


def poseidon2_hash_any(*values) -> int:
    """Hash arbitrary absorbable values (the general native surface;
    ``poseidon2_hash`` is the bytes special case)."""
    sponge = PoseidonSponge()
    for v in values:
        absorb(sponge, v)
    return sponge.squeeze_elements(1)[0]


def absorb_gadget(sponge: "PoseidonSponge", value) -> None:
    """In-circuit absorb: FieldVar, Boolean, UInt8 gadgets (31-byte-packed
    like the native byte path), Edwards point vars, or lists thereof —
    the AbsorbGadget surface."""
    from ..gadgets.boolean import Boolean
    from ..gadgets.field_var import FieldVar
    from ..gadgets.uint import UIntGadget

    if isinstance(value, FieldVar):
        sponge.absorb_elements([value])
        return
    if isinstance(value, Boolean):
        cs = value.cs
        sponge.absorb_elements([_boolean_to_field_var(cs, value)])
        return
    if isinstance(value, (list, tuple)):
        if value and all(isinstance(v, UIntGadget) and v.width == 8 for v in value):
            cs = next(b.cs for b in value if b.cs is not None)
            capacity_bytes = (ConstraintF.PARAMS.modulus_bits - 1) // 8
            p = ConstraintF.PARAMS.modulus
            for off in range(0, len(value), capacity_bytes):
                chunk = value[off : off + capacity_bytes]
                acc = FieldVar.constant(cs, 0)
                for i, byte_gadget in enumerate(chunk):
                    acc = acc.add(
                        _uint8_to_field_var(cs, byte_gadget).mul_by_constant(pow(256, i, p))
                    )
                sponge.absorb_elements([acc])
            return
        for v in value:
            absorb_gadget(sponge, v)
        return
    raise TypeError(f"cannot absorb gadget {type(value).__name__}")


def _boolean_to_field_var(cs, b):
    """Boolean -> FieldVar via its LC (no new constraints)."""
    from ..gadgets.field_var import FieldVar

    return FieldVar(cs, b.lc(), int(b.value()))


def poseidon2_hash_any_gadget(cs, *values):
    """In-circuit twin of :func:`poseidon2_hash_any` (gadget == native by
    shared-ops construction)."""
    sponge = PoseidonSponge(ops=_GadgetOps(cs))
    for v in values:
        absorb_gadget(sponge, v)
    return sponge.squeeze_elements(1)[0]

"""In-circuit Pedersen CRH (the ``PedersenCRHCompressorGadget`` slot;
reference ``src/merkle_tree/common.rs:32-46``).

Same selection-sum algorithm as the native path
(:mod:`simpleworks_tpu_torch.hash.pedersen`), over :class:`EdwardsVar` with
generator points embedded as constants; output is the x-coordinate FieldVar
(TECompressorGadget).

Port of ``simpleworks_tpu/hash/pedersen_gadget.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from ..curves.edwards_gadget import EdwardsVar
from ..gadgets.field_var import FieldVar
from ..gadgets.uint import UIntGadget
from .pedersen import PedersenParameters


def pedersen_evaluate_gadget(
    cs, params: PedersenParameters, input_bytes: list[UIntGadget]
) -> FieldVar:
    """Hash byte gadgets; returns the compressed (x-coordinate) FieldVar."""
    window = params.window
    if len(input_bytes) * 8 > window.capacity_bits:
        raise ValueError("input exceeds Pedersen window capacity")
    n_bytes = (window.capacity_bits + 7) // 8
    padded = list(input_bytes) + [
        UIntGadget.constant(cs, 8, 0) for _ in range(n_bytes - len(input_bytes))
    ]
    bits = []
    for byte_gadget in padded:
        bits.extend(byte_gadget.to_bits_le())
    bits = bits[: window.capacity_bits]

    acc = EdwardsVar.identity(cs)
    for w in range(window.num_windows):
        window_bits = bits[w * window.window_size : (w + 1) * window.window_size]
        for bit, base in zip(window_bits, params.generators[w]):
            base_var = EdwardsVar.constant(cs, base)
            acc = acc.add_conditionally(bit, base_var)
    return acc.x


def pedersen_evaluate_two_to_one_gadget(
    cs, params: PedersenParameters, left: list[UIntGadget], right: list[UIntGadget]
) -> FieldVar:
    return pedersen_evaluate_gadget(cs, params, list(left) + list(right))

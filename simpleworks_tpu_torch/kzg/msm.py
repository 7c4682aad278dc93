"""Multi-scalar multiplication over BLS12-377 G1 on the host (pure Python).

Port of the pure-Python route of ``simpleworks_tpu/kzg/msm.py``: the oracle
for the device MSM, the γ-power MSMs of hiding commitments, and the
fixed-base table that builds the γ powers.  The device MSM is
:mod:`simpleworks_tpu_torch.ops.msm_pippenger`.
"""

from __future__ import annotations

from ..curves.bls12_377 import G1Point
from ..fields.bls12_377 import FR_MODULUS


def msm(points: list[G1Point], scalars: list[int]) -> G1Point:
    """Pippenger bucket method; window size chosen for the input size."""
    if len(points) != len(scalars):
        raise ValueError(f"{len(points)} points but {len(scalars)} scalars")
    pairs = [(p, int(s) % FR_MODULUS) for p, s in zip(points, scalars) if int(s) % FR_MODULUS]
    if not pairs:
        return G1Point.identity()
    n = len(pairs)
    bits = FR_MODULUS.bit_length()
    # window bits: the fewest adds, ⌈bits/c⌉ windows of n bucket adds and
    # 2·2^c running-sum adds each
    c = min(range(2, 17), key=lambda c: -(-bits // c) * (n + (2 << c)))
    num_windows = (bits + c - 1) // c
    window_sums = []
    for w in range(num_windows):
        shift = w * c
        buckets = [None] * ((1 << c) - 1)
        for point, scalar in pairs:
            idx = (scalar >> shift) & ((1 << c) - 1)
            if idx:
                b = buckets[idx - 1]
                buckets[idx - 1] = point if b is None else b.add(point)
        # running-sum trick: sum_i i*bucket_i
        running = G1Point.identity()
        acc = G1Point.identity()
        for b in reversed(buckets):
            if b is not None:
                running = running.add(b)
            acc = acc.add(running)
        window_sums.append(acc)
    # combine: sum_w 2^(cw) * window_sum_w
    total = G1Point.identity()
    for ws in reversed(window_sums):
        for _ in range(c):
            total = total.double()
        total = total.add(ws)
    return total


class FixedBaseMSM:
    """Windowed fixed-base scalar multiplication table (SRS generation)."""

    def __init__(self, base: G1Point, window_bits: int = 8, max_bits: int = 256):
        self.window_bits = window_bits
        self.tables: list[list[G1Point]] = []
        cur = base
        num_windows = (max_bits + window_bits - 1) // window_bits
        for _ in range(num_windows):
            row = [G1Point.identity()]
            for _ in range((1 << window_bits) - 1):
                row.append(row[-1].add(cur))
            self.tables.append(row)
            for _ in range(window_bits):
                cur = cur.double()

    def mul(self, scalar: int) -> G1Point:
        scalar = int(scalar) % FR_MODULUS
        acc = G1Point.identity()
        for w, table in enumerate(self.tables):
            idx = (scalar >> (w * self.window_bits)) & ((1 << self.window_bits) - 1)
            if idx:
                acc = acc.add(table[idx])
        return acc

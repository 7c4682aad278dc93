"""Fast host<->device packing of field elements (bytes-based, avoids
per-limb Python loops).

Port of ``simpleworks_tpu/fields/pack.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import numpy as np

from .device import LIMB_BITS
from .host import FieldParams


#: one limb as a little-endian numpy dtype (LIMB_BITS = 16: "<u2")
_LIMB_DTYPE = f"<u{LIMB_BITS // 8}"


def pack_standard(values: list[int], params: FieldParams) -> np.ndarray:
    """Python ints (standard form) -> [N, L] uint32 base-2^16 limbs."""
    nbytes = params.repr_bits // 8
    buf = b"".join(int(v).to_bytes(nbytes, "little") for v in values)
    limbs = np.frombuffer(buf, dtype=_LIMB_DTYPE).reshape(len(values), params.repr_bits // LIMB_BITS)
    return limbs.astype(np.uint32)


def unpack_standard(arr: np.ndarray, params: FieldParams) -> list[int]:
    """[N, L] uint32 limbs -> Python ints."""
    limbs = np.asarray(arr).astype(_LIMB_DTYPE)
    data = limbs.tobytes()
    nbytes = params.repr_bits // 8
    return [
        int.from_bytes(data[i * nbytes : (i + 1) * nbytes], "little")
        for i in range(limbs.shape[0])
    ]

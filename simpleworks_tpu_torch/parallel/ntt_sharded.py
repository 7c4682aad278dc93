"""The sharded radix-2 NTT over a list of devices: the 4-step transform.

Port of ``simpleworks_tpu/parallel/ntt_sharded.py``.  A transform of size
n = n1·n2 (n1 = 2^⌊log2(n)/2⌋) views the natural-order input as a row-major
[n1, n2] matrix X[j1, j2] = x[j1·n2 + j2] and, with D devices:

1. column transforms of size n1: device d holds columns
   [d·n2/D, (d+1)·n2/D), each a vector of n1, and transforms them as one
   batch (``LimbMatmulNTT.fft_mont_batch``: the tables shared, no Python
   loop over columns);
2. twiddle: Y[k1, j2] · ω_n^(k1·j2) (``dvec.mul``; each shard's table built
   once on its device);
3. transpose: device e gathers rows [e·n1/D, (e+1)·n1/D) of every shard's
   columns, a tensor copy from each shard's device to its own (the
   reference's ``all_to_all``);
4. row transforms of size n2, as one batch a device;

and C[k1, k2] comes back to the input's device in natural order,
x̂[k1 + n1·k2] = C[k1, k2].  The result equals the unsharded transform's
value for value.

Departure from the reference: the inverse carries the 1/n scale (each
stage's inverse tables fold in 1/n1 and 1/n2), so ``inverse=True`` is
``dvec.ifft``; the reference leaves the scale to its caller.  The shards
run one after another from one thread (the card queues each launch, so
shards on distinct cards overlap where no host fetch intervenes).
"""

from __future__ import annotations

import threading

import torch

from ..device import resolve
from ..fields import dvec
from ..fields.bls12_377 import FR_MODULUS, fr_root_of_unity
from ..fields.frvec import FrVec
from ..ops.ntt import _row_powers, get_ntt

P = FR_MODULUS
L = dvec.L

_TWIDDLES: dict = {}
_TWIDDLES_MAX = 64
_TWIDDLES_LOCK = threading.Lock()


def _split(n: int) -> tuple[int, int]:
    n1 = 1 << ((n.bit_length() - 1) // 2)
    return n1, n // n1


def sharded_transform_supported(devices, n: int) -> bool:
    """Whether a transform of ``n`` points splits over ``len(devices)``
    shards: n a power of two ≥ 4 whose factors n1 and n2 both divide by the
    shard count."""
    if n < 4 or n & (n - 1):
        return False
    n1, n2 = _split(n)
    return n1 % len(devices) == 0 and n2 % len(devices) == 0


def _twiddles(n: int, inverse: bool, shards: int, shard: int, device) -> torch.Tensor:
    """[16, n2/shards, n1] Montgomery table ω^(j2·k1) of one shard's columns
    j2 (ω⁻¹ for the inverse), built once per shard and device."""
    key = (n, inverse, shards, shard, str(device))
    with _TWIDDLES_LOCK:
        table = _TWIDDLES.get(key)
    if table is None:
        n1, n2 = _split(n)
        w = n2 // shards
        omega = fr_root_of_unity(n)
        if inverse:
            omega = pow(omega, P - 2, P)
        table = _row_powers([pow(omega, j2, P) for j2 in range(shard * w, (shard + 1) * w)],
                            n1, device)
        with _TWIDDLES_LOCK:
            if len(_TWIDDLES) >= _TWIDDLES_MAX:
                _TWIDDLES.pop(next(iter(_TWIDDLES)))
            _TWIDDLES[key] = table
    return table


def sharded_transform(devices, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
    """The 4-step transform of the [16, n] natural-order Montgomery tensor
    ``x`` over ``devices`` -> [16, n] on ``x``'s device (the inverse scaled
    by 1/n, as ``dvec.ifft``)."""
    devices = [resolve(d) for d in devices]
    n = x.shape[1]
    if not sharded_transform_supported(devices, n):
        raise ValueError(f"a transform of {n} points does not split over {len(devices)} shards")
    shards = len(devices)
    n1, n2 = _split(n)
    w, h = n2 // shards, n1 // shards
    matrix = x.reshape(L, n1, n2)
    twiddled = []
    for d, dev in enumerate(devices):  # column transforms, then the twiddle
        cols = matrix[:, :, d * w:(d + 1) * w].to(dev).permute(0, 2, 1).contiguous()  # [16, w, n1]
        ntt = get_ntt(n1, dev)
        y = ntt.ifft_mont_batch(cols) if inverse else ntt.fft_mont_batch(cols)
        tw = _twiddles(n, inverse, shards, d, dev)
        twiddled.append(dvec.mul(y.reshape(L, -1), tw.reshape(L, -1)).reshape(L, w, n1))
    out = []
    for e, dev in enumerate(devices):  # transpose, then the row transforms
        rows = torch.cat([y[:, :, e * h:(e + 1) * h].to(dev) for y in twiddled], dim=1)
        rows = rows.permute(0, 2, 1).contiguous()  # [16, h, n2]
        ntt = get_ntt(n2, dev)
        z = ntt.ifft_mont_batch(rows) if inverse else ntt.fft_mont_batch(rows)
        out.append(z.to(x.device))
    c = torch.cat(out, dim=1)  # [16, n1, n2]: C[k1, k2]
    return c.permute(0, 2, 1).reshape(L, n)  # x̂[k1 + n1·k2] = C[k1, k2]


def sharded_transform_vec(devices, v: FrVec, inverse: bool = False) -> FrVec:
    """Natural-order FrVec -> its transform (the inverse scaled by 1/n),
    sharded over ``devices``; equal to the unsharded ``dvec.fft``/``ifft``."""
    return FrVec(sharded_transform(devices, v.t, inverse))


def sharded_ntt_host(devices, values: list[int]) -> list[int]:
    """Natural-order standard-form ints in, their forward transform out."""
    devices = [resolve(d) for d in devices]
    return dvec.to_ints(sharded_transform(devices, dvec.from_ints(values, devices[0])))

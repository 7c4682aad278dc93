"""The port's butterfly NTT (simpleworks_tpu_torch.poly.ntt_device over the
plain versions of ops/ntt_butterfly.py's kernels) held against the JAX
package's XLA butterfly (simpleworks_tpu.poly.ntt_device, JAX on the CPU),
the pure-Python ``ntt_host`` and the port's limb-matmul NTT, tolerance 0.
The sharded plane's local transforms run through it in
``test_torch_parallel.py``."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleworks_tpu.poly import ntt_device as ref_ntt
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import fr_root_of_unity
from simpleworks_tpu_torch.fields.device import from_reference_limbs, to_reference_limbs
from simpleworks_tpu_torch.ops import ntt as limb_ntt
from simpleworks_tpu_torch.ops import ntt_butterfly as bf
from simpleworks_tpu_torch.ops._build import LAUNCHES
from simpleworks_tpu_torch.poly import ntt_device
from simpleworks_tpu_torch.poly.domain import ntt_host

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers


def rand_ints(n, seed):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


@pytest.mark.parametrize("n", [2, 8, 64])
def test_fft_ifft_match_reference(n):
    """Limb for limb against the reference's jitted transforms (the
    reference's [n, 16] uint32 is the port's [16, n] int32 transposed), and
    the port's int API against the values they give.  The inputs go in as
    Montgomery limbs: the reference's own int API runs its conversions
    eagerly, a second of compiles a size."""
    vals = rand_ints(n, n)
    port, ref = ntt_device.get_device_ntt(n, "cpu"), ref_ntt.get_device_ntt(n)
    x = dvec.from_ints(vals, CPU)
    x_ref = jnp.asarray(to_reference_limbs(x).T)
    before = dict(LAUNCHES)
    fwd, inv = port.fft_mont(x), port.ifft_mont(x)
    assert LAUNCHES == before  # the plain CPU path launches no kernel
    assert torch.equal(fwd, from_reference_limbs(np.asarray(ref.fft_mont(x_ref)).T, CPU))
    assert torch.equal(inv, from_reference_limbs(np.asarray(ref.ifft_mont(x_ref)).T, CPU))
    assert port.fft(vals) == dvec.to_ints(fwd)
    assert port.ifft(vals) == dvec.to_ints(inv)
    padded = vals[: n // 2] + [0] * (n - n // 2)
    assert port.fft(vals[: n // 2]) == port.fft(padded)


def test_round_trip_and_ntt_host():
    n = 1 << 10
    vals = rand_ints(n, 5)
    port = ntt_device.get_device_ntt(n, CPU)
    evals = port.fft(vals)
    assert evals == ntt_host(vals, fr_root_of_unity(n))
    assert port.ifft(evals) == vals
    assert ntt_device.get_device_ntt(n, CPU) is port  # tables built once
    assert ntt_device.get_device_ntt(1, CPU).fft([7]) == [7]  # n = 1: the identity


def test_batch_matches_single_and_limb_matmul():
    B, n = 3, 64
    x = dvec.from_ints(rand_ints(B * n, 6), CPU).reshape(16, B, n)
    port, limb = ntt_device.get_device_ntt(n, CPU), limb_ntt.get_ntt(n, CPU)
    fwd, inv = port.fft_mont_batch(x), port.ifft_mont_batch(x)
    for b in range(B):
        col = x[:, b].contiguous()
        assert torch.equal(fwd[:, b], port.fft_mont(col))
        assert torch.equal(inv[:, b], port.ifft_mont(col))
    assert torch.equal(fwd, limb.fft_mont_batch(x))
    assert torch.equal(inv, limb.ifft_mont_batch(x))
    assert torch.equal(port.ifft_mont_batch(fwd), x)


@pytest.mark.parametrize("n", [1, 2, 8, 1024])
def test_plain_bit_reversal_matches_reference(n):
    rev = bf.bit_reverse_indices(n, CPU)
    assert np.array_equal(rev.numpy(), ref_ntt._bit_reverse_indices(n))
    x = torch.arange(16 * 2 * n, dtype=torch.int32).reshape(16, 2, n)
    assert torch.equal(bf.ntt_bitrev(x), x[:, :, rev])


def test_bad_inputs_raise():
    port = ntt_device.get_device_ntt(8, CPU)
    with pytest.raises(ValueError):
        port.fft_mont(dvec.zeros(4, CPU))  # wrong width
    with pytest.raises(ValueError):
        port.fft_mont(dvec.zeros(8, CPU).to(torch.int64))  # wrong dtype
    with pytest.raises(ValueError):
        port.fft_mont_batch(dvec.zeros(8, CPU))  # not batched
    with pytest.raises(ValueError):
        port.fft_mont(torch.zeros((16, 8), dtype=torch.int32, device="meta"))  # wrong device
    with pytest.raises(ValueError):
        ntt_device.DeviceNTT(12, CPU)
    with pytest.raises(ValueError):
        port.ifft([1, 2, 3])
    x = torch.zeros((16, 1, 8), dtype=torch.int32)
    with pytest.raises(ValueError):
        bf.ntt_butterfly(x, 3, port.twiddles_fwd)  # stage past log2(n)
    with pytest.raises(ValueError):
        bf.ntt_butterfly(x, 0, port.twiddles_fwd[:, :2])  # short table
    with pytest.raises(ValueError):
        bf.ntt_bitrev(torch.zeros((16, 1, 6), dtype=torch.int32))

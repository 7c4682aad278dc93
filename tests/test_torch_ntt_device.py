"""The port's butterfly NTT (simpleworks_tpu_torch.poly.ntt_device over the
plain versions of ops/ntt_butterfly.py's kernels: the pass kernel's passes,
and the stage route's bit reversal and stages) held against the JAX
package's XLA butterfly (simpleworks_tpu.poly.ntt_device, JAX on the CPU,
compiled at n = 8 and 64 only), the pure-Python ``ntt_host`` and the port's
limb-matmul NTT, tolerance 0.  The plain passes run with tiles of 2^1 to
2^3 points, so that a few points take several passes: tier-1 checks the
kernel's split, in-tile stages and four-step twiddles here, where there is
no card.  The sharded plane's local transforms run through it in
``test_torch_parallel.py``."""

import os
from functools import lru_cache

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


#: the sizes at which the reference's transforms are compiled (~1 s each)
REFERENCE_SIZES = (8, 64)


@lru_cache(maxsize=None)
def reference_batch(n):
    """[16, 3, n] seed-made Montgomery limbs and their forward and inverse
    transforms, column by column: the reference's jitted transforms at
    REFERENCE_SIZES, else ``ntt_host`` (the inverse: ω⁻¹, then 1/n)."""
    vals = rand_ints(3 * n, 100 + n)
    x = dvec.from_ints(vals, CPU).reshape(16, 3, n)
    if n in REFERENCE_SIZES:
        ref = ref_ntt.get_device_ntt(n)
        cols = [jnp.asarray(to_reference_limbs(x[:, b]).T) for b in range(3)]
        fwd, inv = ([from_reference_limbs(np.asarray(f(c)).T, CPU) for c in cols]
                    for f in (ref.fft_mont, ref.ifft_mont))
        return x, torch.stack(fwd, dim=1), torch.stack(inv, dim=1)
    omega = fr_root_of_unity(n)
    n_inv, omega_inv = pow(n, P - 2, P), pow(omega, P - 2, P)
    fwd, inv = [], []
    for b in range(3):
        col = vals[b * n:(b + 1) * n]
        fwd.append(dvec.from_ints(ntt_host(col, omega), CPU))
        inv.append(dvec.from_ints([v * n_inv % P for v in ntt_host(col, omega_inv)], CPU))
    return x, torch.stack(fwd, dim=1), torch.stack(inv, dim=1)


@pytest.mark.parametrize("log_n", range(11))
@pytest.mark.parametrize("max_tile_log", [1, 2, 3])
def test_plain_passes_match_reference(max_tile_log, log_n):
    """The pass kernel's plain version, its tiles forced to at most
    2^max_tile_log points (up to ten passes), batch 1 and 3, both ways."""
    n = 1 << log_n
    x, fwd, inv = reference_batch(n)
    tables = ntt_device.get_device_ntt(n, CPU).tables
    tiles = bf.pass_tiles(log_n, max_tile_log)
    assert sum(tiles) == log_n and max(tiles) <= max_tile_log
    for batch in (x, x[:, :1]):
        B = batch.shape[1]
        assert torch.equal(bf.ntt_passes_plain(batch, tables[False], None, max_tile_log),
                           fwd[:, :B])
        assert torch.equal(bf.ntt_passes_plain(batch, tables[True], pow(n, P - 2, P),
                                               max_tile_log), inv[:, :B])


@pytest.mark.parametrize("n", [1, 2, 64, 1 << 11, 1 << 12])
def test_cpu_route_matches_stage_route(n):
    """DeviceNTT on the CPU (the plain passes at the kernel's tiles: one
    pass up to 2^11, two at 2^12) equals the stage route's plain bit
    reversal and stages, element for element."""
    port = ntt_device.get_device_ntt(n, CPU)
    x = dvec.from_ints(rand_ints(2 * n, 7 * n), CPU).reshape(16, 2, n)
    before = dict(LAUNCHES)
    assert torch.equal(port.fft_mont_batch(x), bf.stage_route(x, port.twiddles_fwd))
    assert torch.equal(port.ifft_mont_batch(x), bf.stage_route(x, port.twiddles_inv, port.n_inv))
    assert LAUNCHES == before  # the plain CPU routes launch no kernel


@pytest.mark.parametrize("n", REFERENCE_SIZES)
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


BAD_PASS_INPUTS = {
    "size": lambda t: bf.ntt_transform(torch.zeros((16, 1, 12), dtype=torch.int32), t),
    "dtype": lambda t: bf.ntt_transform(torch.zeros((16, 1, 8), dtype=torch.int64), t),
    "unbatched": lambda t: bf.ntt_transform(torch.zeros((16, 8), dtype=torch.int32), t),
    "device": lambda t: bf.ntt_transform(torch.zeros((16, 1, 8), dtype=torch.int32,
                                                     device="meta"), t),
    "tile_0": lambda t: bf.ntt_passes_plain(torch.zeros((16, 1, 8), dtype=torch.int32), t, None, 0),
    "tile_12": lambda t: bf.pass_tiles(20, 12),
    "unpacked": lambda t: bf._check_tables(torch.zeros((16, 1, 8), dtype=torch.int32), t, 3),
}


@pytest.mark.parametrize("case", list(BAD_PASS_INPUTS))
def test_pass_route_rejects_bad_inputs(case):
    """Bad sizes, types, devices and tiles raise; the kernel refuses tables
    that are not packed on the data's device (a CPU transform has none)."""
    with pytest.raises(ValueError):
        BAD_PASS_INPUTS[case](ntt_device.get_device_ntt(8, CPU).tables[False])

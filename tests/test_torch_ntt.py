"""The port's NTT (simpleworks_tpu_torch.ops.ntt, dvec.fft/ifft) held against
the JAX package on the CPU, tolerance 0: the plain reduce against the Pallas
``_reduce_kernel`` in interpret mode on real partial-limb planes, the
transforms against the reference's domain NTT and the port's pure-Python
``ntt_host``, and the level-table tree against ``_build_level_tables``."""

import os

import numpy as np
import pytest
import torch

from simpleworks_tpu.poly.domain import Radix2Domain as RefDomain
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import fr_root_of_unity
from simpleworks_tpu_torch.fields.device import from_reference_limbs
from simpleworks_tpu_torch.ops import ntt
from simpleworks_tpu_torch.ops._build import LAUNCHES
from simpleworks_tpu_torch.poly.domain import ntt_host

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

rng = np.random.default_rng(31)


def rand_ints(n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def test_plain_reduce_matches_pallas_interpret():
    """One 128-lane tile of the real first-level planes of a 1024-point
    transform, plus the largest planes the bound allows."""
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from simpleworks_tpu.ops.ntt_mxu import _make_reduce

    x = dvec.from_ints(rand_ints(1024), CPU)
    planes = ntt.get_ntt(1024, CPU).partial_planes(x)[:, :128].contiguous()
    assert 0 <= int(planes.min()) and int(planes.max()) < 1 << 29
    planes[:, 0] = (1 << 29) - 1  # every plane at its bound: the largest sum
    planes[:, 1] = 0
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(_make_reduce(128)(jnp.asarray(planes.numpy())))
    before = dict(LAUNCHES)
    got = ntt.ntt_reduce(planes)
    assert torch.equal(got, from_reference_limbs(ref, CPU))
    assert LAUNCHES == before  # the plain CPU path launches no kernel
    assert torch.equal(got, ntt.ntt_reduce_plain(planes))


@pytest.mark.parametrize("n", [1, 2, 4, 256, 1 << 12])
def test_fft_ifft_match_reference_and_ntt_host(n):
    vals = rand_ints(n)
    evals = dvec.fft(dvec.from_ints(vals, CPU), n)
    expected = RefDomain(n).fft(vals)
    assert dvec.to_ints(evals) == expected
    if n <= 256:  # the pure-Python oracle, where it is quick
        assert ntt_host(vals, fr_root_of_unity(n)) == expected
    assert dvec.to_ints(dvec.ifft(evals, n)) == vals
    assert dvec.to_ints(dvec.ifft(dvec.from_ints(vals, CPU), n)) == RefDomain(n).ifft(vals)


def test_fft_pads_short_inputs_and_refuses_long_ones():
    vals = rand_ints(5)
    assert dvec.to_ints(dvec.fft(dvec.from_ints(vals, CPU), 8)) == RefDomain(8).fft(vals)
    with pytest.raises(ValueError):
        dvec.fft(dvec.from_ints(rand_ints(9), CPU), 8)


def test_level_table_tree_matches_reference():
    from simpleworks_tpu.ops.ntt_mxu import _build_level_tables

    n = 1 << 13
    omega = fr_root_of_unity(n)
    kind, n1, n2, w1_8, t_mont, sub = ntt._build_level_tables(n, omega, 1, CPU)
    r_kind, r_n1, r_n2, r_w1, r_t, r_sub = _build_level_tables(n, omega, 1)
    assert (kind, n1, n2) == (r_kind, r_n1, r_n2) == ("split", 128, 64)
    assert w1_8.shape == (32, 128, 128) and t_mont.shape == (16, n)
    assert np.array_equal(w1_8.numpy(), np.asarray(r_w1, dtype=np.float32))
    assert torch.equal(t_mont, from_reference_limbs(np.asarray(r_t), CPU))
    assert sub[:2] == r_sub[:2] == ("base", 64)
    assert np.array_equal(sub[2].numpy(), np.asarray(r_sub[2], dtype=np.float32))


def test_transforms_are_cached_and_reduce_checks_inputs():
    assert ntt.get_ntt(64, CPU) is ntt.get_ntt(64, CPU)
    with pytest.raises(ValueError):
        ntt.ntt_reduce(torch.zeros((62, 4), dtype=torch.int32))
    with pytest.raises(ValueError):
        ntt.ntt_reduce(torch.zeros((63, 4), dtype=torch.int64))
    with pytest.raises(ValueError):
        ntt.LimbMatmulNTT(12, CPU)
    with pytest.raises(ValueError):
        ntt.get_ntt(8, CPU).fft_mont(dvec.zeros(4, CPU))

"""The port's device polynomial plane (simpleworks_tpu_torch.fields.dvec)
held against the JAX package's dvec on the CPU, value for value.

Every reference call at a new width is a fresh XLA compile, so the cases
share one width (N) wherever the function allows."""

import os

import numpy as np
import pytest
import torch

from simpleworks_tpu.fields import dvec as ref
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.device import from_reference_limbs, mont_scalar

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

N = 3  # odd: the halving tree carries a lane
rng = np.random.default_rng(21)


def rand_limbs(n):
    """[16, n] uint32 Montgomery limbs of values < p."""
    limbs = rng.integers(0, 1 << 16, size=(16, n), dtype=np.int64)
    limbs[-1] %= P >> 240
    return limbs.astype(np.uint32)


def same(port_t, ref_arr):
    return torch.equal(port_t, from_reference_limbs(np.asarray(ref_arr), CPU))


@pytest.mark.parametrize("op", ["mul", "add", "sub"])
def test_elementwise_matches_reference(op):
    import jax.numpy as jnp

    a, b = rand_limbs(N), rand_limbs(N)
    a[:, 0] = 0
    b[:, 1] = a[:, 1]  # a − a and a + a lanes
    got = getattr(dvec, op)(from_reference_limbs(a, CPU), from_reference_limbs(b, CPU))
    assert same(got, getattr(ref, op)(jnp.asarray(a), jnp.asarray(b)))


def test_scale_rsub_pow_inv_match_reference():
    import jax.numpy as jnp

    a = rand_limbs(N)
    a[:, 0] = 0  # inv keeps zero at zero
    ta, ja = from_reference_limbs(a, CPU), jnp.asarray(a)
    s = 123456789
    assert torch.equal(mont_scalar(s, device=CPU), from_reference_limbs(ref.mont_scalar_np(s), CPU))
    assert same(dvec.scale(ta, mont_scalar(s, device=CPU)), ref.scale(ja, ref.mont_scalar_np(s)))
    assert same(dvec.rsub_scalar(ta, mont_scalar(s, device=CPU)), ref.rsub_scalar(ja, ref.mont_scalar_np(s)))
    # a short exponent against the reference; the reference's CPU inverse
    # unrolls 254 Montgomery multiplies into one XLA program (minutes to
    # compile), so the Fermat inverse is held against the host field
    assert same(dvec.pow_const(ta, 0b1011001), ref.pow_const(ja, 0b1011001))
    inv = dvec.inv(ta)
    vals = dvec.to_ints(ta)
    assert dvec.to_ints(inv) == [pow(v, P - 2, P) for v in vals]
    assert dvec.to_ints(inv)[0] == 0


def test_sum_evaluate_powers_match_reference():
    import jax.numpy as jnp

    a = rand_limbs(N)
    ta, ja = from_reference_limbs(a, CPU), jnp.asarray(a)
    assert dvec.limb_sums_to_int(dvec.sum_limbs_raw(ta)) == ref.limb_sums_to_int(
        np.asarray(ref.sum_limbs_raw(ja)))
    assert same(dvec.sum_reduce(ta), ref.sum_reduce(ja))
    z = 987654321
    assert same(dvec.evaluate(ta, z), ref.evaluate(ja, z))
    assert dvec.scalar_to_int(dvec.evaluate(ta, z)) == ref.scalar_to_int(ref.evaluate(ja, z))
    assert same(dvec.powers_vec(31337, N, CPU), ref.powers_vec(31337, N))


@pytest.mark.parametrize("n", [1, N])
def test_divide_by_linear_matches_reference(n):
    import jax.numpy as jnp

    a = rand_limbs(n)
    z = 424242
    q, r = dvec.divide_by_linear(from_reference_limbs(a, CPU), z)
    qr, rr = ref.divide_by_linear(jnp.asarray(a), ref.mont_scalar_np(z), z_int=z)
    assert same(q, qr)
    assert same(r, rr)
    vals = dvec.to_ints(from_reference_limbs(a, CPU))
    assert dvec.scalar_to_int(r) == sum(v * pow(z, i, P) for i, v in enumerate(vals)) % P


def test_divide_by_linear_long_scan():
    """A width that is not a power of two runs every step of the log-step
    suffix scan; held against host synthetic division."""
    vals = [int.from_bytes(rng.bytes(32), "little") % P for _ in range(37)]
    z = 31337
    q, r = dvec.divide_by_linear(dvec.from_ints(vals, CPU), z)
    quot, carry = [0] * 36, 0
    for i in range(36, 0, -1):
        carry = (carry * z + vals[i]) % P
        quot[i - 1] = carry
    assert dvec.to_ints(q) == quot
    assert dvec.scalar_to_int(r) == (carry * z + vals[0]) % P


def test_sum_limbs_raw_large_no_overflow():
    """Raw limb sums stay exact at widths where a u32 accumulator wraps —
    the reference's σ₂-corruption regression case (2^15 lanes)."""
    import jax.numpy as jnp

    n = 1 << 15
    vals = [P - 1 - i for i in range(n)]
    t = dvec.from_ints(vals, CPU)
    expected = sum(vals) % P
    assert dvec.limb_sums_to_int(dvec.sum_limbs_raw(t)) == expected
    ref_arr = jnp.asarray(t.numpy().astype(np.uint32))
    assert ref.limb_sums_to_int(np.asarray(ref.sum_limbs_raw(ref_arr))) == expected


def test_host_bridges_round_trip():
    vals = [0, 1, P - 1, 5, 123456789]
    t = dvec.from_ints(vals, CPU)
    assert dvec.to_ints(t) == vals
    assert dvec.scalar_to_int(t[:, 2:3]) == P - 1
    assert dvec.to_ints(dvec.pad_to(t, 7)) == vals + [0, 0]
    assert dvec.to_ints(dvec.const_vec(9, 3, CPU)) == [9, 9, 9]


def test_host_bridges_match_reference():
    """``from_frvec`` / ``to_frvec`` against the reference's (its FrVec is a
    host [N, 4] u64 array, the port's a device tensor: the limbs compare),
    and ``mont_scalar_np``'s column."""
    from simpleworks_tpu.fields.frvec import FrVec as RefFrVec
    from simpleworks_tpu_torch.fields.frvec import FrVec

    vals = [int.from_bytes(rng.bytes(33), "little") % P for _ in range(N)]
    ref_t = np.asarray(ref.from_frvec(RefFrVec.from_ints(vals)))
    got = dvec.from_frvec(FrVec.from_ints(vals, CPU))
    assert same(got, ref_t)
    back = dvec.to_frvec(got)
    assert back.t is got and back.to_ints() == vals == ref.to_frvec(ref_t).to_ints()
    for s in (0, 1, 123456789, P - 1):
        col = dvec.mont_scalar_np(s)
        assert col.dtype == np.uint32 and np.array_equal(col, ref.mont_scalar_np(s))
        assert torch.equal(torch.from_numpy(col.astype(np.int32)), mont_scalar(s, device=CPU))

"""The port's field layer (simpleworks_tpu_torch.fields, ops.mont_mul) held
against the JAX package on the same numpy-seeded inputs, tolerance 0: field
arithmetic is exact.  The reference's Pallas kernels run in interpret mode
at a 128-lane tile, as tests/test_pallas.py runs them."""

import os

import numpy as np
import pytest
import torch

from simpleworks_tpu.fields import bls12_377 as ref_fields
from simpleworks_tpu.fields import device as ref_device
from simpleworks_tpu.utils import rng as ref_rng
from simpleworks_tpu_torch.fields import bls12_377 as fields
from simpleworks_tpu_torch.fields import device
from simpleworks_tpu_torch.fields.device import FQ, FR
from simpleworks_tpu_torch.ops import mont_mul as mm
from simpleworks_tpu_torch.utils import rng as port_rng

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

TILE = 128  # smallest legal Pallas lane tile: keeps interpret mode quick


def canonical_limbs(field, n, seed):
    """[L, n] uint32 limbs of values < p, with 0, 1 and p−1 in the first lanes."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(field.n_limbs, n), dtype=np.int64)
    limbs[-1] %= field.p_limbs[-1]
    limbs[:, 0] = 0
    limbs[:, 1] = [1] + [0] * (field.n_limbs - 1)
    limbs[:, 2] = device.ints_to_limbs([field.p - 1], field.n_limbs)[:, 0]
    return limbs.astype(np.uint32)


def test_host_fields_and_rng_match_reference():
    r1, r2 = ref_rng.test_rng(), port_rng.test_rng()
    for ref_cls, cls in ((ref_fields.Fr, fields.Fr), (ref_fields.Fq, fields.Fq)):
        for _ in range(5):
            a, b = ref_cls.rand(r1), cls.rand(r2)
            assert a.value == b.value
            assert a.serialize() == b.serialize()
            assert (a * a).sqrt().value == (b * b).sqrt().value
            assert a.inverse().value == b.inverse().value
    assert ref_fields.Fr.rand_vec(r1, 7) == fields.Fr.rand_vec(r2, 7)
    assert r1.next_u64() == r2.next_u64()


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
def test_limb_packing_matches_reference(field):
    params = field.params
    rng = np.random.default_rng(1)
    vals = [int.from_bytes(rng.bytes(48), "little") % field.p for _ in range(9)] + [0, 1, field.p - 1]
    limbs = device.ints_to_limbs(vals, field.n_limbs)
    assert np.array_equal(limbs.T.astype(np.uint32),
                          np.stack([ref_device.int_to_limbs(v, field.n_limbs) for v in vals]))
    assert device.limbs_to_ints(limbs) == vals
    ref_mont = np.asarray(ref_device.DeviceField(params).to_mont(vals)).T  # [L, N] u32
    port_mont = device.to_mont(vals, field, CPU)
    assert torch.equal(port_mont, device.from_reference_limbs(ref_mont, CPU))
    assert np.array_equal(device.to_reference_limbs(port_mont), ref_mont)
    assert device.from_mont(port_mont, field) == vals
    with pytest.raises(ValueError):
        device.from_reference_limbs(np.full((field.n_limbs, 2), 1 << 16, np.uint32), CPU)


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
def test_plain_kernels_match_pallas_interpret(field):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from simpleworks_tpu.ops.mont_mul_pallas import make_mod_addsub, make_mont_mul

    a_np = canonical_limbs(field, TILE, 2)
    b_np = canonical_limbs(field, TILE, 3)[:, ::-1].copy()  # edge values meet each other
    with pltpu.force_tpu_interpret_mode():
        ref_mul = np.asarray(make_mont_mul(field.params, tile=TILE)(jnp.asarray(a_np), jnp.asarray(b_np)))
        add, sub = make_mod_addsub(field.params, tile=TILE)
        ref_add = np.asarray(add(jnp.asarray(a_np), jnp.asarray(b_np)))
        ref_sub = np.asarray(sub(jnp.asarray(a_np), jnp.asarray(b_np)))
    a, b = device.from_reference_limbs(a_np, CPU), device.from_reference_limbs(b_np, CPU)
    assert torch.equal(mm.mont_mul(a, b, field), device.from_reference_limbs(ref_mul, CPU))
    assert torch.equal(mm.mod_add(a, b, field), device.from_reference_limbs(ref_add, CPU))
    assert torch.equal(mm.mod_sub(a, b, field), device.from_reference_limbs(ref_sub, CPU))
    # strided views and broadcast columns give what their copies give
    col = a[:, 5:6].expand_as(b)
    assert torch.equal(mm.mont_mul(col, b[:, ::1], field), mm.mont_mul(col.contiguous(), b, field))


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
def test_mont_pow_matches_pallas_interpret_and_host(field):
    import jax.numpy as jnp
    from jax.experimental.pallas import tpu as pltpu

    from simpleworks_tpu.ops.mont_mul_pallas import make_mont_pow

    x_np = canonical_limbs(field, TILE, 4)
    e = 0b101  # short exponent: keeps the interpret-mode chain cheap
    with pltpu.force_tpu_interpret_mode():
        ref = np.asarray(make_mont_pow(field.params, e, tile=TILE)(jnp.asarray(x_np)))
    x = device.from_reference_limbs(x_np, CPU)
    assert torch.equal(mm.mont_pow(x, e, field), device.from_reference_limbs(ref, CPU))
    # the Fermat exponent of the path (p−2 for Fr, q−2 for Fq) against host pow
    small = x[:, :6]
    got = device.from_mont(mm.mont_pow(small, field.p - 2, field), field)
    vals = device.from_mont(small, field)
    assert got == [pow(v, field.p - 2, field.p) for v in vals]
    assert got[0] == 0  # 0 maps to 0


#: exponents at the window's edges: tiny ones, the top bit alone and all 384
#: bits set, a run of zeros longer than any window, the two Fermat exponents
#: and seeded random 384-bit values
_EDGE_RNG = np.random.default_rng(8)
POW_EDGES = {
    "0": 0, "1": 1, "2": 2, "3": 3, "2^383": 1 << 383, "2^384-1": (1 << 384) - 1,
    "zero_run": (0b1011 << 40) | (1 << 21) | 0b11,
    "fr_p-2": FR.p - 2, "fq_q-2": FQ.p - 2,
    **{f"random{k}": int.from_bytes(_EDGE_RNG.bytes(48), "little") for k in range(3)},
}


@pytest.mark.parametrize("window", [1, 4, 5])
@pytest.mark.parametrize("name", list(POW_EDGES))
def test_pow_schedule_rebuilds_exponent(name, window):
    e = POW_EDGES[name]
    schedule = mm.pow_schedule(e, window)
    assert sum(digit << shift for digit, shift in schedule) == e
    assert all(digit % 2 == 1 and digit < 1 << window for digit, _ in schedule)
    shifts = [shift for _, shift in schedule]
    assert shifts == sorted(shifts, reverse=True) and len(set(shifts)) == len(shifts)
    # a digit's bits never overlap the next digit's: the windows are disjoint
    assert all(hi - lo >= digit.bit_length() for (digit, lo), (_, hi) in
               zip(schedule[1:], schedule))
    assert (schedule == ()) == (e == 0)
    assert mm.pow_table_size(schedule) == max([d for d, _ in schedule], default=1) // 2 + 1


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
def test_scheduled_plain_pow_matches_host_at_window_edges(field):
    """The plain pow along the schedule against host pow (mod p) on 0, 1,
    p−1 and random lanes, exact, with no launch, for the edge exponents that
    the Fermat check above does not walk (random exponents: the schedule
    test)."""
    x = device.from_reference_limbs(canonical_limbs(field, 4, 9), CPU)
    vals = device.from_mont(x, field)
    before = dict(mm.LAUNCHES)
    for name in ("0", "1", "2", "3", "zero_run", "2^384-1"):
        e = POW_EDGES[name]
        got = mm.mont_pow(x, e, field)
        assert got.is_contiguous() and got.dtype == torch.int32, name
        assert device.from_mont(got, field) == [pow(v, e, field.p) for v in vals], name
    assert mm.LAUNCHES == before
    # a strided view gives what its copy gives, and e = 1 returns a copy
    wide = device.from_reference_limbs(canonical_limbs(field, 12, 10), CPU)
    e = POW_EDGES["zero_run"]
    assert torch.equal(mm.mont_pow(wide[:, 3:9], e, field),
                       mm.mont_pow(wide[:, 3:9].contiguous(), e, field))
    same = mm.mont_pow(wide, 1, field)
    assert torch.equal(same, wide) and same.data_ptr() != wide.data_ptr()


def test_wrappers_check_inputs():
    a = device.to_mont([1, 2, 3], FR, CPU)
    with pytest.raises(TypeError):
        mm.mod_add(a.to(torch.int64), a.to(torch.int64), FR)
    with pytest.raises(ValueError):
        mm.mod_add(a, a, FQ)
    with pytest.raises(ValueError):
        mm.mod_add(a, a[:, :2], FR)
    before = dict(mm.LAUNCHES)
    mm.mont_mul(a, a, FR)
    assert mm.LAUNCHES == before  # the plain CPU path launches no kernel


# ----------------------------------------------------------- DeviceField --

DF_LANES = 16
DF_EXPONENT = 5  # a short exponent keeps the reference's unrolled chain cheap


@pytest.fixture(scope="module", params=[FR, FQ], ids=["fr", "fq"])
def device_field_pair(request):
    """Both packages' DeviceField of one field, seeded inputs (0, 1 and p−1
    among them) and the reference's results of every op, computed once in
    one jitted call of its own methods (its eager ops cost ~4 s a field)."""
    import jax
    import jax.numpy as jnp

    field = request.param
    ref_df = ref_device.DeviceField(field.params)
    a_np = canonical_limbs(field, DF_LANES, 11)
    b_np = canonical_limbs(field, DF_LANES, 12)[:, ::-1].copy()
    cond = np.arange(DF_LANES) % 3 == 0

    def ops(a, b, c):
        return dict(add=ref_df.add(a, b), sub=ref_df.sub(a, b), neg=ref_df.neg(a),
                    mul=ref_df.mul(a, b), square=ref_df.square(a),
                    mul_scalar_mont=ref_df.mul_scalar_mont(a, b[4]),
                    pow=ref_df.pow_host_exponent(a, DF_EXPONENT), select=ref_df.select(c, a, b),
                    is_zero=ref_df.is_zero(a), eq=ref_df.eq(a, a.at[3].set(b[3])),
                    normalize=ref_df.normalize(a + b))

    ref = jax.jit(ops)(jnp.asarray(a_np.T), jnp.asarray(b_np.T), jnp.asarray(cond))
    ref = {k: np.asarray(v) for k, v in ref.items()}
    return field, ref_df, device.DeviceField(field.params), a_np, b_np, cond, ref


def test_device_field_constants_match_reference(device_field_pair):
    field, ref_df, df, *_ = device_field_pair
    assert df.n_limbs == ref_df.n_limbs and df.field is field
    for name in ("p_int", "r_int", "r2_int", "n0"):
        assert getattr(df, name) == getattr(ref_df, name), name
    for name in ("p_limbs", "r_limbs", "r2_limbs", "zero", "one_mont"):
        got, want = getattr(df, name), getattr(ref_df, name)
        assert got.dtype == want.dtype and np.array_equal(got, want), name
    v = int.from_bytes(np.random.default_rng(13).bytes(48), "little") % field.p
    assert np.array_equal(device.int_to_limbs(v, df.n_limbs), ref_device.int_to_limbs(v, df.n_limbs))
    assert device.limbs_to_int(device.int_to_limbs(v, df.n_limbs)) == ref_device.limbs_to_int(
        ref_device.int_to_limbs(v, df.n_limbs)) == v


def test_device_field_ops_match_reference(device_field_pair):
    """Every op on [L, B] tensors against the reference's on [B, L] arrays,
    and against host integers; no kernel launch on the CPU."""
    field, ref_df, df, a_np, b_np, cond, ref = device_field_pair
    p = field.p
    a, b = device.from_reference_limbs(a_np, CPU), device.from_reference_limbs(b_np, CPU)
    before = dict(mm.LAUNCHES)
    got = dict(add=df.add(a, b), sub=df.sub(a, b), neg=df.neg(a), mul=df.mul(a, b),
               square=df.square(a), mul_scalar_mont=df.mul_scalar_mont(a, b[:, 4:5]),
               pow=df.pow_host_exponent(a, DF_EXPONENT),
               select=df.select(torch.from_numpy(cond), a, b),
               normalize=df.normalize(a + b))
    assert mm.LAUNCHES == before
    for name, t in got.items():
        assert t.dtype == torch.int32 and t.shape == a.shape, name
        assert np.array_equal(device.to_reference_limbs(t), ref[name].T), name
    x, y = df.from_mont(a), df.from_mont(b)
    assert df.from_mont(got["mul"]) == [u * v % p for u, v in zip(x, y)]
    assert df.from_mont(got["pow"]) == [pow(u, DF_EXPONENT, p) for u in x]
    assert df.is_zero(a).tolist() == ref["is_zero"].tolist() == [u == 0 for u in x]
    a_eq = a.clone()
    a_eq[:, 3] = b[:, 3]
    assert df.eq(a, a_eq).tolist() == ref["eq"].tolist()
    # a column broadcasts over the lanes; an exponent past 384 bits is taken mod p − 1
    assert torch.equal(df.add(a, b[:, 4:5]), df.add(a, b[:, 4:5].expand_as(a)))
    big = (p - 1) * (1 << 200) + DF_EXPONENT
    assert torch.equal(df.pow_host_exponent(a, big), got["pow"])
    assert df.from_mont(df.pow_host_exponent(a, (p - 1) << 200)) == [int(u != 0) for u in x]
    assert df.from_mont(df.to_mont(x, CPU)) == x
    assert np.array_equal(device.to_reference_limbs(df.to_mont(x, CPU)),
                          np.asarray(ref_df.to_mont(x)).T)

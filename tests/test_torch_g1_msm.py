"""The port's G1 layer held against the JAX package on the same inputs: host
curve serde and pairing, limb-major point arithmetic
(simpleworks_tpu_torch.ops.g1_limb), the MSM's bucket accumulate
(ops.g1_fused.madd_accumulate, whose CUDA kernel runs a group's whole scan
in one launch) and bucket combine (ops.g1_fused.bucket_combine, whose CUDA
kernel runs a group's fold and suffix passes in one launch), the device
Pippenger MSM (ops.msm_pippenger) and the fixed-base SRS powers
(ops.srs_device).  Limb tensors are compared value for value and group
elements exactly.

The reference's limb-major point ops run jitted on the CPU (their XLA
Montgomery multiply), which is the JAX package's own CPU route.  Its add and
mixed add are compiled once each, at 64 lanes, for the add and madd tests,
the accumulate's scan steps and the combine's fold and suffix steps; the
reference's whole accumulate program is not compiled here (tens of
seconds)."""

import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from simpleworks_tpu import native
from simpleworks_tpu.curves import bls12_377 as ref_curves
from simpleworks_tpu.curves.pairing import multi_pairing as ref_multi_pairing
from simpleworks_tpu.kzg.msm import msm as ref_msm
from simpleworks_tpu.ops import g1_limb as ref_g1
from simpleworks_tpu_torch.curves.bls12_377 import G1Point, G2Point
from simpleworks_tpu_torch.curves.pairing import multi_pairing
from simpleworks_tpu_torch.fields.bls12_377 import FQ_MODULUS as Q
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.device import (
    FQ, FR, from_mont, from_reference_limbs, ints_to_limbs, to_mont, to_reference_limbs,
)
from simpleworks_tpu_torch.kzg.msm import msm
from simpleworks_tpu_torch.ops import g1_fused, g1_limb, msm_pippenger, srs_device

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

rng = np.random.default_rng(33)
G = G1Point.generator()
#: the reference's add and mixed add, each compiled once for the LANES-wide
#: tests below
REF_ADD = jax.jit(ref_g1.add)
REF_MADD = jax.jit(ref_g1.madd)
LANES = 64
DEPTH = 3


def rand_scalars(n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def ref_point(pt):
    return ref_curves.G1Point(pt.X, pt.Y, pt.Z)


def ref_planes(planes):
    return tuple(jnp.asarray(to_reference_limbs(a)) for a in planes)


def same_planes(port, ref):
    return len(port) == len(ref) and all(
        torch.equal(a, from_reference_limbs(np.asarray(b), CPU)) for a, b in zip(port, ref)
    )


def edge_cases():
    """(p, q) rows: generic, doubling, P + (−P), identities on either side."""
    p3, p5 = G.scalar_mul(3), G.scalar_mul(5)
    ident = G1Point.identity()
    return [(p3, p5), (p3, p3), (p3, p3.neg()), (ident, p5), (p3, ident), (ident, ident)]


def test_serde_and_pairing_match_reference():
    pts = [G.scalar_mul(int(k)) for k in rng.integers(1, 1 << 62, 3)] + [G1Point.identity()]
    for pt in pts:
        data = pt.serialize_compressed()
        assert data == ref_point(pt).serialize_compressed()
        assert G1Point.deserialize_compressed(data) == pt
    h = G2Point.generator().scalar_mul(12345)
    ref_h = ref_curves.G2Point.generator().scalar_mul(12345)
    assert h.serialize_compressed() == ref_h.serialize_compressed()
    assert G2Point.deserialize_compressed(h.serialize_compressed()) == h
    got = multi_pairing([(pts[0], h), (pts[1].neg(), G2Point.generator())])
    expected = ref_multi_pairing(
        [(ref_point(pts[0]), ref_h), (ref_point(pts[1]).neg(), ref_curves.G2Point.generator())]
    )
    assert repr(got) == repr(expected)
    # bilinearity: e(7a, h) · e(−a, 7h) = 1
    assert multi_pairing([(pts[0].scalar_mul(7), h), (pts[0].neg(), h.scalar_mul(7))]) == \
        type(got).one()


def test_packing_matches_reference():
    pts = [G.scalar_mul(k) for k in (2, 3, 1000)] + [G1Point.identity()]
    port = g1_limb.points_to_limb_major(pts, CPU)
    assert same_planes(port, ref_g1.points_to_limb_major([ref_point(p) for p in pts]))
    assert g1_limb.points_from_limb_major(port) == pts
    affine = g1_limb.points_to_limb_major_affine(pts, CPU)
    assert same_planes(affine, ref_g1.points_to_limb_major_affine([ref_point(p) for p in pts]))
    assert g1_limb.points_from_affine_planes(torch.stack(affine[:2])) == pts


def test_add_and_double_match_reference():
    cases = (edge_cases() * LANES)[:LANES]
    p = g1_limb.points_to_limb_major([a for a, _ in cases], CPU)
    q = g1_limb.points_to_limb_major([b for _, b in cases], CPU)
    got = g1_limb.add(p, q)
    assert same_planes(got, REF_ADD(ref_planes(p), ref_planes(q)))
    assert g1_limb.points_from_limb_major(got) == [a.add(b) for a, b in cases]
    dbl = g1_limb.double(p)
    assert same_planes(dbl, jax.jit(ref_g1.double)(ref_planes(p)))
    assert g1_limb.points_from_limb_major(dbl) == [a.double() for a, _ in cases]


def test_madd_matches_reference():
    cases = (edge_cases() * LANES)[:LANES]
    p = g1_limb.points_to_limb_major([a for a, _ in cases], CPU)
    q2 = g1_limb.points_to_limb_major_affine([b for _, b in cases], CPU)[:2]
    got = g1_limb.madd(p, q2)
    assert same_planes(got, REF_MADD(ref_planes(p), ref_planes(q2)))
    assert g1_limb.points_from_limb_major(got) == [a.add(b) for a, b in cases]


def test_affine_madd_matches_reference():
    cases = [(a, b, True) for a, b in edge_cases()]
    cases += [(G.scalar_mul(3), G.scalar_mul(5), False), (G1Point.identity(), G, False)]
    acc = g1_limb.points_to_limb_major_affine([a for a, _, _ in cases], CPU)[:2]
    q2 = g1_limb.points_to_limb_major_affine([b for _, b, _ in cases], CPU)[:2]
    valid = [v for _, _, v in cases]
    got = g1_limb.affine_madd(acc, q2, torch.tensor(valid))
    expected = jax.jit(ref_g1.affine_madd)(ref_planes(acc), ref_planes(q2), jnp.asarray(valid))
    assert same_planes(got, expected)
    jac = g1_limb.affine_to_jacobian(got)
    assert same_planes(jac, jax.jit(ref_g1.affine_to_jacobian)(ref_planes(got)))
    assert g1_limb.points_from_limb_major(jac) == [a.add(b) if v else a for a, b, v in cases]


def test_batch_inverse_matches_reference():
    vals = [int.from_bytes(rng.bytes(48), "little") % Q or 1 for _ in range(13)]
    x = to_mont(vals, FQ, CPU)
    got = g1_limb.FqLimb(base=2).batch_inverse(x)  # three levels, odd widths padded
    expected = ref_g1.FqLimb(tile=128).batch_inverse(jnp.asarray(to_reference_limbs(x)))
    assert torch.equal(got, from_reference_limbs(np.asarray(expected), CPU))
    assert from_mont(got, FQ) == [pow(v, Q - 2, Q) for v in vals]
    # the halves of a strided view are strided views: same inverses
    wide = to_mont(vals[:12] * 2, FQ, CPU)
    assert torch.equal(g1_limb.FqLimb(base=2).batch_inverse(wide[:, 12:]), got[:, :12])


def table_rows(points):
    """Host points -> the [n, 48] int32 affine table the accumulate reads."""
    x, y, _ = g1_limb.points_to_limb_major_affine(points, CPU)
    return torch.cat([x, y]).t().contiguous()


@pytest.fixture(scope="module")
def accumulate_grid():
    """A table of 8 points (row 7 the identity) and a [3, 64] grid with
    invalid cells, a repeated index (a doubling: lane 0 adds P twice), P then
    -P (lane 1), the identity row (lane 2), and seed-made cells elsewhere."""
    pts = [G.scalar_mul(11 * k + 2) for k in range(6)]
    pts = pts + [pts[0].neg(), G1Point.identity()]
    rng = np.random.default_rng(5)
    idx = rng.integers(0, len(pts), size=(DEPTH, LANES))
    valid = rng.random((DEPTH, LANES)) < 0.75
    idx[:, 0], valid[:, 0] = [0, 0, 3], True
    idx[:, 1], valid[:, 1] = [0, 6, 2], True
    idx[:, 2], valid[:, 2] = [7, 1, 7], True
    idx[:, 3], valid[:, 3] = [4, 5, 1], [False, True, False]
    return pts, table_rows(pts), torch.from_numpy(idx), torch.from_numpy(valid)


def reference_scan(rows, idx, valid, acc=None):
    """The reference's scan step (gather, madd, select), one row at a time."""
    ref_rows = jnp.asarray(to_reference_limbs(rows.t().contiguous()).T)  # [n, 48] uint32
    acc = ref_g1.identity(idx.shape[1]) if acc is None else acc
    for d in range(idx.shape[0]):
        pts2 = jnp.take(ref_rows, jnp.asarray(idx[d].numpy()), axis=0).T.reshape(2, 24, -1)
        added = REF_MADD(acc, (pts2[0], pts2[1]))
        acc = ref_g1.select_point(jnp.asarray(valid[d].numpy()), added, acc)
    return acc


def test_accumulate_plain_matches_reference_scan(accumulate_grid):
    pts, rows, idx, valid = accumulate_grid
    got = g1_fused.madd_accumulate_plain(None, rows, idx, valid)
    expected = reference_scan(rows, idx, valid)
    assert all(torch.equal(a, from_reference_limbs(np.asarray(b), CPU))
               for a, b in zip(got, expected))
    sums = g1_limb.points_from_limb_major(got)
    for j in range(LANES):
        total = G1Point.identity()
        for d in range(DEPTH):
            if valid[d, j]:
                total = total.add(pts[idx[d, j]])
        assert sums[j] == total, j
    assert sums[0] == pts[0].double().add(pts[3]) and sums[1] == pts[2]
    assert sums[2] == pts[1] and sums[3] == pts[5]


def test_accumulate_from_a_start_is_the_mixed_add_at_depth_one(accumulate_grid):
    _, rows, idx, valid = accumulate_grid
    start = g1_fused.madd_accumulate_plain(None, rows, idx[:2], valid[:2])
    q2 = tuple(a.t().contiguous() for a in rows.index_select(0, idx[2]).split(24, dim=1))
    expected = g1_limb.madd(start, q2)
    ones = torch.ones((1, LANES), dtype=torch.bool)
    got = g1_fused.madd_accumulate_plain(start, rows, idx[2:], ones)
    assert all(map(torch.equal, got, expected))
    # the wrapper on CPU tensors is the plain version, and counts no launch
    before = dict(g1_fused.LAUNCHES)
    assert all(map(torch.equal, g1_fused.madd_accumulate(start, rows, idx[2:], ones), expected))
    assert all(map(torch.equal, g1_fused.fused_madd(start, q2), expected))
    assert g1_fused.LAUNCHES == before
    # two rows then the third from their sum: the three-row scan
    whole = g1_fused.madd_accumulate_plain(None, rows, idx, valid)
    resumed = g1_fused.madd_accumulate_plain(start, rows, idx[2:], valid[2:])
    assert all(map(torch.equal, whole, resumed))


@pytest.mark.parametrize("bad", ["table_width", "idx_dtype", "valid_shape", "acc_lanes"])
def test_accumulate_rejects_bad_inputs(accumulate_grid, bad):
    _, rows, idx, valid = accumulate_grid
    acc = None
    if bad == "table_width":
        rows = rows[:, :24]
    elif bad == "idx_dtype":
        idx = idx.to(torch.int32)
    elif bad == "valid_shape":
        valid = valid[:, :5]
    else:
        acc = g1_limb.identity(LANES - 1, CPU)
    with pytest.raises(ValueError):
        g1_fused.madd_accumulate(acc, rows, idx, valid)


def ref_add_lanes(p, q):
    """The reference's add on up to LANES lanes (zero-padded to its compiled
    width; the formula is lane by lane)."""
    n = p[0].shape[1]
    pad = ((0, 0), (0, LANES - n))
    out = REF_ADD(tuple(np.pad(a, pad) for a in p), tuple(np.pad(a, pad) for a in q))
    return tuple(np.asarray(a)[:, :n] for a in out)


def reference_combine(acc, w_count, segs, b):
    """The reference's segment fold and two suffix passes
    (simpleworks_tpu/ops/msm_pippenger.py accumulate_windows), one jitted
    add a step; the halves, shifts and T0 reset are moved in numpy, so that
    the add is the one program compiled."""
    acc = tuple(np.asarray(a) for a in acc)
    s = segs
    while s > 1:
        half = s // 2
        t4 = tuple(a.reshape(24, w_count, s, b) for a in acc)
        left = tuple(a[:, :, :half].reshape(24, w_count * half * b) for a in t4)
        right = tuple(a[:, :, half:].reshape(24, w_count * half * b) for a in t4)
        acc = ref_add_lanes(left, right)
        s = half
    ident = tuple(np.asarray(a).reshape(24, w_count, b) for a in ref_g1.identity(w_count * b))

    def suffix_pass(t):
        for i in range(b.bit_length() - 1):
            k = 1 << i  # the reference's dynamic_slice_in_dim(concat(t, identity), k, b)
            shifted = tuple(np.concatenate([a, p], axis=2)[:, :, k : k + b]
                            .reshape(24, w_count * b) for a, p in zip(t, ident))
            flat = tuple(a.reshape(24, w_count * b) for a in t)
            t = tuple(a.reshape(24, w_count, b) for a in ref_add_lanes(flat, shifted))
        return t

    t = suffix_pass(tuple(a.reshape(24, w_count, b) for a in acc))
    t = tuple(np.concatenate([i[:, :, :1], a[:, :, 1:]], axis=2) for a, i in zip(t, ident))
    t = suffix_pass(t)
    return tuple(a[:, :, 0] for a in t)


def combine_points(w_count, segs, b, seed):
    """Host bucket sums of a (W, S, b) grid, lane w·S·b + s·b + d, from a
    pool of seed-made points.  For W = 2, S = 4, b = 8, crafted lanes: in
    window 0 (segment 0; the other segments of these buckets the identity)
    buckets 2 and 3 are one point (a suffix step doubles), buckets 4 and 5
    are Q and -Q (a suffix step cancels) and bucket 6 is the identity in
    every segment; in window 1 bucket 1 has one point in segments 0 and 2
    (the first fold doubles), bucket 2 has P and -P in segments 1 and 3 (the
    first fold cancels), and bucket 7 is the identity in every segment."""
    rng = np.random.default_rng(seed)
    pool = [G.scalar_mul(int(k)) for k in rng.integers(2, 1 << 20, size=8)]
    pts = [pool[i] for i in rng.integers(0, len(pool), size=w_count * segs * b)]
    if (w_count, segs, b) == (2, 4, 8):
        ident = G1Point.identity()

        def put(w, d, values):
            for s_, v in enumerate(values):
                pts[w * segs * b + s_ * b + d] = v

        p, q = pool[0], pool[1]
        put(0, 2, [p, ident, ident, ident])
        put(0, 3, [p, ident, ident, ident])
        put(0, 4, [q, ident, ident, ident])
        put(0, 5, [q.neg(), ident, ident, ident])
        put(0, 6, [ident] * 4)
        put(1, 1, [p, q, p, q.neg()])
        put(1, 2, [q, p, ident, p.neg()])
        put(1, 7, [ident] * 4)
    return pts


def window_sums(pts, w_count, segs, b):
    """Σ_d d·S_d of each window by the host point law."""
    out = []
    for w in range(w_count):
        total = G1Point.identity()
        for d in range(1, b):
            bucket = G1Point.identity()
            for s_ in range(segs):
                bucket = bucket.add(pts[w * segs * b + s_ * b + d])
            total = total.add(bucket.scalar_mul(d))
        out.append(total)
    return out


@pytest.mark.parametrize("w_count,segs,b", [(1, 1, 2), (2, 4, 8), (3, 2, 16)])
def test_bucket_combine_plain_matches_reference(w_count, segs, b):
    pts = combine_points(w_count, segs, b, 40 + b)
    acc = g1_limb.points_to_limb_major(pts, CPU)
    got = g1_fused.bucket_combine_plain(acc, w_count, segs, b)
    assert same_planes(got, reference_combine(ref_planes(acc), w_count, segs, b))
    assert g1_limb.points_from_limb_major(got) == window_sums(pts, w_count, segs, b)
    # the wrapper on CPU tensors is the plain version, and counts no launch
    before = dict(g1_fused.LAUNCHES)
    assert all(map(torch.equal, g1_fused.bucket_combine(acc, w_count, segs, b), got))
    assert g1_fused.LAUNCHES == before


def test_bucket_combine_crafted_lanes_hit_their_cases():
    """The crafted buckets of combine_points meet as the doc says: equal
    points, P and -P, and identities, as the fold's and the first suffix
    step's operands."""
    pts = combine_points(2, 4, 8, 48)
    at = [[pts[w * 32 + s_ * 8 + d] for s_ in range(4)] for w in range(2) for d in range(8)]
    w0 = [functools.reduce(G1Point.add, at[d]) for d in range(8)]
    assert w0[2] == w0[3] != G1Point.identity()
    assert w0[4] == w0[5].neg() != G1Point.identity() and w0[6] == G1Point.identity()
    w1 = at[8:]
    assert w1[1][0] == w1[1][2] and w1[2][1] == w1[2][3].neg()
    assert all(pt == G1Point.identity() for pt in w1[7])


@pytest.mark.parametrize("bad", ["pair", "dtype", "lanes", "segments", "buckets", "one_bucket",
                                 "strided", "device"])
def test_bucket_combine_rejects_bad_inputs(bad):
    w_count, segs, b = 2, 2, 4
    acc = g1_limb.identity(w_count * segs * b, CPU)
    error = ValueError
    if bad == "pair":
        acc = acc[:2]
    elif bad == "dtype":
        acc, error = tuple(a.to(torch.int64) for a in acc), TypeError
    elif bad == "lanes":
        acc = tuple(a[:, :-1] for a in acc)
    elif bad == "segments":
        acc, segs = g1_limb.identity(w_count * 3 * b, CPU), 3
    elif bad == "buckets":
        acc, b = g1_limb.identity(w_count * segs * 6, CPU), 6
    elif bad == "one_bucket":
        acc, b = g1_limb.identity(w_count * segs, CPU), 1
    elif bad == "strided":
        acc = tuple(torch.cat([a, a], dim=1)[:, ::2] for a in acc)
    else:
        acc = (acc[0], acc[1], torch.empty_like(acc[2], device="meta"))
    with pytest.raises(error):
        g1_fused.bucket_combine(acc, w_count, segs, b)


def test_default_accumulate_is_madd_on_every_device():
    assert msm_pippenger.default_accum(torch.device("cuda")) == "madd"
    assert msm_pippenger.default_accum(CPU) == "madd"


@pytest.fixture(scope="module")
def table():
    """1100 affine points as the reference stores an SRS, and as the port's
    [2, 24, N] planes."""
    scalars = [(i * 6364136223846793005 + 1442695040888963407) % P for i in range(1100)]
    pts_native = native.g1_ensure_normalized(
        native.g1_fixed_base_raw(ref_curves.G1Point.generator(), scalars)
    )
    return pts_native, g1_limb.native_points_to_limb_major(pts_native, CPU)


@pytest.mark.parametrize("n", [33, 64, 130])
def test_msm_matches_reference_host_msm(table, n):
    pts_native, xy = table
    offset = 7
    scalars = rand_scalars(n)
    scalars[0], scalars[1] = 0, 1
    got = msm_pippenger.msm_device_mont(xy, to_mont(scalars, FR, CPU), offset=offset)
    expected = ref_msm(native._points_from_native(pts_native[offset : offset + n]), scalars)
    assert got.serialize_compressed() == expected.serialize_compressed()


@pytest.mark.parametrize("accum", ["affine", "madd"])
def test_msm_accumulate_modes_with_repeated_points(accum):
    """Equal points in one bucket (doubling) and P, −P sharing every digit
    (cancellation), through both accumulate steps and the standard-form
    entry."""
    pts = [G.scalar_mul(7 * i + 2) for i in range(12)]
    pts[3] = pts[2]
    pts[5] = pts[4].neg()
    scalars = rand_scalars(12)
    scalars[4] = scalars[5] = 9
    xy = torch.stack(g1_limb.points_to_limb_major_affine(pts, CPU)[:2])
    std = np.array([[(s >> (64 * k)) & (2**64 - 1) for k in range(4)] for s in scalars], "<u8")
    got = msm_pippenger.msm_device(xy, std, c=4, accum=accum)
    assert got == msm(pts, scalars)
    assert got.serialize_compressed() == ref_msm(
        [ref_point(p) for p in pts], scalars).serialize_compressed()


@pytest.mark.slow  # the reference's CPU accumulate program compiles for ~45 s
def test_msm_matches_reference_msm_device_mont(table):
    from simpleworks_tpu.fields.frvec import FrVec
    from simpleworks_tpu.ops import msm_pippenger as ref_msm_pippenger

    pts_native, xy = table
    scalars = rand_scalars(40)
    scalars[0], scalars[3] = 0, 1
    got = msm_pippenger.msm_device_mont(xy, to_mont(scalars, FR, CPU), c=8)
    ref_xy = ref_g1.native_points_to_limb_major(pts_native)
    expected = ref_msm_pippenger.msm_device_mont(ref_xy, FrVec.from_ints(scalars), c=8)
    assert got.serialize_compressed() == expected.serialize_compressed()


def test_window_digits_and_schedule_grid():
    """Digits rebuild their scalars, and the device grid places every
    (window, nonzero digit) point exactly once."""
    n, c = 21, 5
    scalars = rand_scalars(n)
    mont = to_mont(scalars, FR, CPU)
    digits, stats = msm_pippenger.mont_digits(mont, c)
    for i, s in enumerate(scalars):
        assert sum(int(digits[w, i]) << (w * c) for w in range(digits.shape[0])) == s
    metas = msm_pippenger._meta_from_stats(
        [(w, int(o), max(int(m), 1)) for w, (o, m) in enumerate(stats.tolist())], lanes=64
    )
    for window_ids, segs, b_g, depth in metas:
        ids = torch.tensor(window_ids)
        idx, valid = msm_pippenger.device_grid_from_digits(
            digits.index_select(0, ids), depth, segs, b_g, 0)
        idx = idx.reshape(depth, len(window_ids), segs, b_g)
        valid = valid.reshape(depth, len(window_ids), segs, b_g)
        for slot, w in enumerate(window_ids):
            for d in range(b_g):
                members = sorted(idx[:, slot, :, d][valid[:, slot, :, d]].tolist())
                expected = (digits[w] == d).nonzero().flatten().tolist() if d else []
                assert members == expected, (w, d)


def test_fixed_base_powers_match_reference():
    scalars = [0, 1, P - 1] + rand_scalars(34)
    std = torch.from_numpy(ints_to_limbs(scalars, FR.n_limbs).astype(np.int32))
    jac = srs_device.fixed_base_powers_device(G, std)
    expected = native.g1_fixed_base_raw(ref_curves.G1Point.generator(), scalars)  # [N, 18] u64
    planes = np.ascontiguousarray(expected).view("<u2").reshape(-1, 3, 24).transpose(1, 2, 0)
    assert torch.equal(torch.stack(jac), torch.from_numpy(planes.astype(np.int32)))
    affine = srs_device.fixed_base_powers_affine(G, std)
    assert torch.equal(affine, g1_limb.native_points_to_limb_major(
        native.g1_normalize_arr(expected), CPU))


# --------------------------------------------- curves/g1_device (batched) --


def test_g1_device_batch_ops_match_host_point_law():
    """``curves.g1_device`` on a batch holding the identity, a doubling
    (P + P), a cancellation (P + (−P)) and random pairs, against the JAX
    package's host point law (its JAX twins are eager scans: ~1 min for a
    tree of 8 points here)."""
    from simpleworks_tpu_torch.curves import g1_device

    ref_g = ref_curves.G1Point.generator()
    ps = [ref_g.scalar_mul(s) for s in rand_scalars(6)] + [ref_curves.G1Point.identity()] * 2
    qs = [ref_g.scalar_mul(s) for s in rand_scalars(8)]
    qs[1], qs[2], qs[7] = ps[1], ps[2].neg(), ps[3]  # doubling, cancellation, identity + Q
    to_port = lambda pts: [G1Point(p.X, p.Y, p.Z) for p in pts]  # noqa: E731
    p_dev = g1_device.points_to_device(to_port(ps), CPU)
    q_dev = g1_device.points_to_device(to_port(qs), CPU)
    assert g1_device.points_from_device(p_dev) == to_port(ps)
    assert g1_device.is_identity(p_dev).tolist() == [p.is_identity() for p in ps]
    sums = g1_device.points_from_device(g1_device.add(p_dev, q_dev))
    assert [ref_point(s) for s in sums] == [p.add(q) for p, q in zip(ps, qs)]
    twice = g1_device.points_from_device(g1_device.double(p_dev))
    assert [ref_point(s) for s in twice] == [p.double() for p in ps]
    ident = g1_device.identity_like(8, CPU)
    assert g1_device.is_identity(ident).all()
    cond = torch.tensor([k % 2 == 0 for k in range(8)])
    picked = g1_device.points_from_device(g1_device.select_point(cond, p_dev, ident))
    assert [ref_point(s) for s in picked] == [p if k % 2 == 0 else ref_curves.G1Point.identity()
                                              for k, p in enumerate(ps)]
    total = g1_device.points_from_device(g1_device.tree_reduce(p_dev))
    expected = ref_curves.G1Point.identity()
    for p in ps:
        expected = expected.add(p)
    assert len(total) == 1 and ref_point(total[0]) == expected
    with pytest.raises(ValueError, match="power-of-two"):
        g1_device.tree_reduce(tuple(c[:, :6] for c in p_dev))
    assert g1_device.fq_device_field().field is FQ


def test_g1_device_fixed_base_ladder_matches_host_scalar_mul():
    """The ladder at 20 bits (the card checks 253) on scalars with bits
    above the ladder's (ignored, as in the reference), zero and one."""
    from simpleworks_tpu_torch.curves import g1_device

    bits = 20
    ref_base = ref_curves.G1Point.generator().scalar_mul(7)
    scalars = rand_scalars(5) + [0, 1, (1 << bits) - 1]
    out = g1_device.points_from_device(g1_device.scalar_mul_fixed_base_batch(
        G1Point(ref_base.X, ref_base.Y, ref_base.Z), scalars, num_bits=bits, device=CPU))
    assert [ref_point(p) for p in out] == [ref_base.scalar_mul(s % (1 << bits)) for s in scalars]

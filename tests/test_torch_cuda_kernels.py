"""The port's CUDA kernels (the field kernels, the NTT's reduce kernel, the
butterfly NTT's pass kernel and the stage route's bit reversal and stage,
the fused G1 point add, the MSM's bucket accumulate and its bucket
combine, the setup's fixed base) against their plain PyTorch versions, on
the card (exact equality: field arithmetic is exact).

Skips without a CUDA device.  On a machine with one:
    python -m pytest -m cuda tests/test_torch_cuda_kernels.py
"""

import numpy as np
import pytest
import torch

from simpleworks_tpu_torch.fields.device import FQ, FR, from_mont
from simpleworks_tpu_torch.ops import mont_mul as mm

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def rand_field(field, n, seed, device):
    """[L, n] canonical limbs with 0, 1 and p−1 in the first lanes."""
    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(field.n_limbs, n), dtype=np.int64)
    limbs[-1] %= field.p_limbs[-1]  # top limb below p's: value < p
    edge = [[0] * field.n_limbs, [1] + [0] * (field.n_limbs - 1), list(field.p_limbs)]
    edge[2][0] -= 1
    for j, col in enumerate(edge[: min(3, n)]):
        limbs[:, j] = col
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
@pytest.mark.parametrize("n", [1, 257, 5000])
def test_binary_kernels_match_plain(cuda, field, n):
    a = rand_field(field, n, 1, cuda)
    b = rand_field(field, n, 2, cuda).flip(1).contiguous()
    for op, plain in ((mm.mont_mul, mm.mont_mul_plain), (mm.mod_add, mm.mod_add_plain),
                      (mm.mod_sub, mm.mod_sub_plain)):
        before = dict(mm.LAUNCHES)
        got = op(a, b, field)
        torch.cuda.synchronize()
        assert torch.equal(got, plain(a, b, field)), op.__name__
        assert mm.LAUNCHES[op.__name__] == before[op.__name__] + 1


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
def test_strided_views_and_broadcast_columns(cuda, field):
    """Slices of a wider tensor (row stride > B) and expanded [L, 1] columns
    (column stride 0) read correctly without a copy."""
    wide = rand_field(field, 1000, 3, cuda)
    lo, hi = wide[:, :500], wide[:, 500:]
    col = rand_field(field, 1, 4, cuda)[:, :1].expand(field.n_limbs, 500)
    for op, plain in ((mm.mont_mul, mm.mont_mul_plain), (mm.mod_add, mm.mod_add_plain),
                      (mm.mod_sub, mm.mod_sub_plain)):
        assert torch.equal(op(lo, hi, field), plain(lo.contiguous(), hi.contiguous(), field))
        assert torch.equal(op(lo, col, field), plain(lo.contiguous(), col.contiguous(), field))


#: exponents at the schedule's window edges (tests/test_torch_fields.py
#: POW_EDGES): tiny ones, the top bit alone, all 384 bits, a run of zeros
#: longer than a window, seeded random 384-bit values
_EDGE_RNG = np.random.default_rng(8)
POW_EDGES = (0, 1, 2, 3, 0xDEADBEEF12345, 1 << 383, (1 << 384) - 1,
             (0b1011 << 40) | (1 << 21) | 0b11,
             *(int.from_bytes(_EDGE_RNG.bytes(48), "little") for _ in range(2)))


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
def test_mont_pow_matches_plain(cuda, field):
    """The kernel against the plain pow, which walks the same schedule, and
    against host pow(), which does not."""
    x = rand_field(field, 300, 5, cuda)
    values = from_mont(x.cpu(), field)
    for e in (*POW_EDGES, field.p - 2):
        before = mm.LAUNCHES["mont_pow"]
        got = mm.mont_pow(x, e, field)
        torch.cuda.synchronize()
        assert torch.equal(got, mm.mont_pow_plain(x, e, field)), e
        assert from_mont(got.cpu(), field) == [pow(v, e, field.p) for v in values], e
        assert mm.LAUNCHES["mont_pow"] == before + 1


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
@pytest.mark.parametrize("side", ["narrow", "wide"])
def test_mont_pow_both_block_sizes(cuda, field, side):
    """Widths on both sides of the kernel's switch from one-warp blocks to
    128-thread blocks (a wave of those over the card's SMs), each with a
    ragged last block, at the Fermat exponent."""
    wave = 128 * torch.cuda.get_device_properties(cuda).multi_processor_count
    n = wave - 1 if side == "narrow" else wave + 37
    x = rand_field(field, n, 7, cuda)
    got = mm.mont_pow(x, field.p - 2, field)
    torch.cuda.synchronize()
    assert torch.equal(got, mm.mont_pow_plain(x, field.p - 2, field))


@pytest.mark.parametrize("field", [FR, FQ], ids=["fr", "fq"])
def test_mont_pow_reads_strided_columns(cuda, field):
    """A column slice of a wider tensor (row stride > B) and every other
    column (column stride 2) give what their copies give."""
    wide = rand_field(field, 1200, 8, cuda)
    for view in (wide[:, 100:700], wide[:, ::2]):
        got = mm.mont_pow(view, field.p - 2, field)
        torch.cuda.synchronize()
        assert torch.equal(got, mm.mont_pow_plain(view.contiguous(), field.p - 2, field))


def test_mont_pow_kernel_resources(cuda):
    res = mm.kernel_resources()
    assert set(res) == {8, 12}
    assert all(r["registers"] > 0 and r["local_bytes"] >= 0 for r in res.values())


def test_mont_pow_entry_rejects_bad_schedules(cuda):
    """The C entry refuses a schedule the kernel cannot walk, and launches
    nothing: (steps, n_table)."""
    import ctypes

    from simpleworks_tpu_torch.ops._build import library

    x = rand_field(FR, 64, 9, cuda)
    out = torch.zeros_like(x)
    bad = (([2], 1),                 # an even top digit
           ([1 << 16 | 1], 1),       # squarings before the top digit
           ([1, 1 << 16 | 4], 4),    # an even later digit
           ([1, 1 << 16 | 9], 4),    # a digit beyond the table
           ([1], 0), ([1], 9),       # no table, a table past 8 powers
           ([1] * 385, 1))           # more steps than a 384-bit exponent has
    for steps, n_table in bad:
        words = (ctypes.c_uint32 * len(steps))(*steps)
        rc = library().swt_mont_pow(
            FR.n_words, x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), x.shape[1],
            FR.p_words_ptr, FR.n0_32, FR.one_words_ptr, ctypes.addressof(words), len(steps),
            n_table, torch.cuda.current_stream().cuda_stream)
        assert rc != 0, (steps[:2], n_table)
    torch.cuda.synchronize()
    assert not out.any()


def test_wrapper_rejects_bad_inputs(cuda):
    a = rand_field(FR, 8, 6, cuda)
    with pytest.raises(TypeError):
        mm.mont_mul(a.to(torch.int64), a.to(torch.int64), FR)
    with pytest.raises(ValueError):
        mm.mont_mul(a, a, FQ)
    with pytest.raises(ValueError):
        mm.mod_add(a, a.cpu(), FR)


def test_ntt_reduce_matches_plain(cuda):
    """The reduce kernel on the real first-level planes of a 4096-point
    transform, and on planes at the kernel's bound (every plane 2^29 − 1)."""
    from simpleworks_tpu_torch.ops import ntt

    x = rand_field(FR, 4096, 7, cuda)
    planes = ntt.get_ntt(4096, cuda).partial_planes(x)
    planes[:, :3] = (1 << 29) - 1
    before = dict(mm.LAUNCHES)
    got = ntt.ntt_reduce(planes)
    torch.cuda.synchronize()
    assert torch.equal(got, ntt.ntt_reduce_plain(planes))
    assert mm.LAUNCHES["ntt_reduce"] == before["ntt_reduce"] + 1
    # a view with a wider row stride is read through its stride
    wide = torch.cat([planes, planes], dim=1)[:, 4096:]
    assert torch.equal(ntt.ntt_reduce(wide), got)


def test_ntt_matches_host_oracle(cuda):
    from simpleworks_tpu_torch.fields import dvec
    from simpleworks_tpu_torch.fields.bls12_377 import fr_root_of_unity
    from simpleworks_tpu_torch.poly.domain import ntt_host

    for n in (1, 8, 512):
        x = rand_field(FR, n, 8, cuda)
        y = dvec.fft(x, n)
        assert dvec.to_ints(y) == ntt_host(dvec.to_ints(x), fr_root_of_unity(n))
        assert torch.equal(dvec.ifft(y, n), x)


@pytest.mark.parametrize("batch, log_n", [(1, 12), (5, 9)])
def test_ntt_butterfly_kernels_match_plain(cuda, batch, log_n):
    """The bit reversal and every butterfly stage (forward and inverse
    tables, with and without the last stage's scale) against their plain
    versions on the card, one launch counted per call; the whole batched
    transform against the CPU's."""
    from simpleworks_tpu_torch.ops import ntt_butterfly as bf
    from simpleworks_tpu_torch.poly.ntt_device import get_device_ntt

    n = 1 << log_n
    x = rand_field(FR, batch * n, 12, cuda).reshape(16, batch, n)
    before = dict(mm.LAUNCHES)
    y = bf.ntt_bitrev(x)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["ntt_bitrev"] == before["ntt_bitrev"] + 1
    assert torch.equal(y, bf.ntt_bitrev_plain(x))
    ntt = get_device_ntt(n, cuda)
    for stage in range(log_n):
        for table, scale in ((ntt.twiddles_fwd, None), (ntt.twiddles_inv, ntt.n_inv)):
            got, want = y.clone(), y.clone()
            bf.ntt_butterfly(got, stage, table, scale)
            torch.cuda.synchronize()
            assert torch.equal(got, bf.ntt_butterfly_plain(want, stage, table, scale)), stage
    assert mm.LAUNCHES["ntt_butterfly"] == before["ntt_butterfly"] + 2 * log_n
    cpu = get_device_ntt(n, torch.device("cpu"))
    assert torch.equal(ntt.fft_mont_batch(x).cpu(), cpu.fft_mont_batch(x.cpu()))
    assert torch.equal(ntt.ifft_mont_batch(x).cpu(), cpu.ifft_mont_batch(x.cpu()))


def fused_cases(ins):
    """(launch-count name, kernel wrapper, plain version, arguments) of the
    two fused point adds on one set of g1_inputs."""
    from simpleworks_tpu_torch.ops import g1_fused

    return [("g1_fused_add", g1_fused.fused_add, g1_fused.fused_add_plain, (ins["p3"], ins["q3"])),
            ("g1_fused_madd", g1_fused.fused_madd, g1_fused.fused_madd_plain,
             (ins["p3"], ins["q2"]))]


def pass_batch(log_n, batch, device):
    """[16, batch, 2^log_n] seed-made limbs; past 2^22 lanes, column b is
    column b % 4 of a smaller draw rolled by b (distinct columns)."""
    n = 1 << log_n
    if batch * n <= 1 << 22:
        return rand_field(FR, batch * n, 13 + log_n, device).reshape(16, batch, n)
    base = rand_field(FR, 4 * n, 13 + log_n, device).reshape(16, 4, n)
    return torch.stack([base[:, b % 4].roll(b, dims=1) for b in range(batch)], dim=1)


@pytest.mark.parametrize("batch", [1, 3, 128])
@pytest.mark.parametrize("log_n", list(range(13)) + [16, 20])
def test_ntt_pass_kernel_matches_plain(cuda, log_n, batch):
    """The pass kernel against its plain passes on the card, forward and
    inverse, one launch counted a pass of its plan; past 2^22 lanes the
    first, second and last transforms of the batch are held (the plain
    version's temporaries)."""
    from simpleworks_tpu_torch.ops import ntt_butterfly as bf
    from simpleworks_tpu_torch.poly.ntt_device import get_device_ntt

    x = pass_batch(log_n, batch, cuda)
    ntt = get_device_ntt(1 << log_n, cuda)
    passes = len(bf.pass_plan(log_n, batch))
    cols = range(batch) if batch << log_n <= 1 << 22 else (0, 1, batch - 1)
    for inverse in (False, True):
        tables, scale = ntt.tables[inverse], (ntt.n_inv if inverse else None)
        before = mm.LAUNCHES["ntt_pass"]
        got = bf.ntt_transform(x, tables, scale)
        torch.cuda.synchronize()
        assert mm.LAUNCHES["ntt_pass"] == before + passes
        if len(cols) == batch:
            assert torch.equal(got, bf.ntt_passes_plain(x, tables, scale))
        for b in () if len(cols) == batch else cols:
            want = bf.ntt_passes_plain(x[:, b : b + 1].contiguous(), tables, scale)
            assert torch.equal(got[:, b : b + 1], want), b
        del got


def test_ntt_pass_kernel_resources(cuda):
    """Registers, spills and shared memory of the pass kernel: every default
    plan from 2^0 to 2^30 points fits its thread and shared-memory limits."""
    from simpleworks_tpu_torch.ops import ntt_butterfly as bf

    res = bf.kernel_resources()
    assert 0 < res["registers"] <= 65536 // res["max_threads"]
    assert res["local_bytes"] == 0
    for log_n in range(31):
        for log_t, log_c, threads, _ in bf.pass_plan(log_n, 1):
            assert threads <= res["max_threads"]
            assert bf.tile_smem_bytes(log_t, log_c) <= res["smem_limit"]


def test_ntt_pass_rejects_bad_inputs(cuda):
    """Bad plans, tables and tensors raise, and launch nothing."""
    from simpleworks_tpu_torch.ops import ntt_butterfly as bf
    from simpleworks_tpu_torch.poly.ntt_device import get_device_ntt

    x = rand_field(FR, 8, 14, cuda).reshape(16, 1, 8)
    tables = get_device_ntt(8, cuda).tables[False]
    before = mm.LAUNCHES["ntt_pass"]
    for plan in (((2, 0, 32, 0),),    # the tiles do not sum to log2(n)
                 ((3, 6, 32, 0),),    # 64 columns a block
                 ((3, 0, 1024, 0),),  # more threads than the kernel's bound
                 ((3, 0, 48, 0),),    # not whole warps
                 ((3, 0, 32, 2),)):   # neither build
        with pytest.raises(RuntimeError):
            bf.ntt_transform(x, tables, None, plan)
    for args in ((x, get_device_ntt(8, torch.device("cpu")).tables[False]),  # host tables
                 (x, get_device_ntt(16, cuda).tables[False]),              # another size's
                 (x.to(torch.int64), tables),
                 (rand_field(FR, 12, 15, cuda).reshape(16, 1, 12), tables)):
        with pytest.raises(ValueError):
            bf.ntt_transform(*args)
    assert mm.LAUNCHES["ntt_pass"] == before


@pytest.mark.parametrize("n", [1, 257, 5000])
def test_fused_point_adds_match_plain(cuda, n):
    """Every lane case (identities, doubling, P + (-P), general) against the
    plain version and the composed adds, one launch counted per call."""
    from chip_smoke import g1_inputs
    from simpleworks_tpu_torch.ops import g1_limb

    ins = g1_inputs(n, 9, cuda)
    composed = {"g1_fused_add": g1_limb._add_composed, "g1_fused_madd": g1_limb._madd_composed}
    for name, op, plain, args in fused_cases(ins):
        before = mm.LAUNCHES[name]
        got = op(*args)
        torch.cuda.synchronize()
        assert mm.LAUNCHES[name] == before + 1
        expected = plain(*args)
        assert all(torch.equal(a, b) for a, b in zip(got, expected)), name
        assert all(torch.equal(a, b) for a, b in zip(got, composed[name](*args))), name
        if n <= 257:
            assert g1_limb.points_from_limb_major(got) == \
                [p.add(q) for p, q in zip(ins["p"], ins["q"])], name


def test_fused_point_adds_read_strided_halves(cuda):
    from chip_smoke import g1_inputs

    ins = g1_inputs(1000, 10, cuda)
    halves = {k: (tuple(a[:, :500] for a in ins[k]), tuple(a[:, 500:] for a in ins[k]))
              for k in ("p3", "q3", "q2")}
    lo = {k: v[0] for k, v in halves.items()}
    hi = {k: v[1] for k, v in halves.items()}
    for (_, op, plain, args_lo), (_, _, _, args_hi) in zip(fused_cases(lo), fused_cases(hi)):
        args = (args_lo[0], args_hi[1])  # p from the low half, q from the high half
        dense = tuple(tuple(a.contiguous() for a in pt) for pt in args)
        assert all(torch.equal(a, b) for a, b in zip(op(*args), plain(*dense)))


def test_fused_point_adds_reject_bad_inputs(cuda):
    from chip_smoke import g1_inputs
    from simpleworks_tpu_torch.ops import g1_fused

    ins = g1_inputs(8, 11, cuda)
    p3, q3 = ins["p3"], ins["q3"]
    with pytest.raises(TypeError):
        g1_fused.fused_add(tuple(a.to(torch.int64) for a in p3), q3)
    with pytest.raises(ValueError):
        g1_fused.fused_add(p3, (q3[0].cpu(), q3[1], q3[2]))
    with pytest.raises(ValueError):
        g1_fused.fused_madd(p3, q3[:1])
    with pytest.raises(ValueError):
        g1_fused.fused_madd(p3, (q3[0][:16], q3[1][:16]))


def accumulate_grid(n, depth, seed, device):
    """g1_inputs of n lanes, the q2 of every lane as an n-row table, and a
    [depth, n] grid whose row 0 adds each lane's own q (the lane cases
    against p3) and whose later rows add seed-made rows, 4 cells in 5 valid."""
    from chip_smoke import g1_inputs

    ins = g1_inputs(n, seed, device)
    rows = torch.cat(ins["q2"]).t().contiguous()
    rng = np.random.default_rng(seed)
    idx = torch.from_numpy(rng.integers(0, n, size=(depth, n))).to(device)
    valid = torch.from_numpy(rng.random((depth, n)) < 0.8).to(device)
    idx[0] = torch.arange(n, device=device)
    valid[0] = True
    return ins, rows, idx, valid


@pytest.mark.parametrize("depth", [1, 5])
@pytest.mark.parametrize("n", [1, 257, 5000])
def test_madd_accumulate_matches_plain(cuda, depth, n):
    """The accumulate kernel, from the identity and from a start, one launch
    counted per call."""
    from simpleworks_tpu_torch.ops import g1_fused

    ins, rows, idx, valid = accumulate_grid(n, depth, 14 + depth, cuda)
    for acc in (None, ins["p3"]):
        expected = g1_fused.madd_accumulate_plain(acc, rows, idx, valid)
        before = mm.LAUNCHES["g1_fused_madd"]
        got = g1_fused.madd_accumulate(acc, rows, idx, valid)
        torch.cuda.synchronize()
        assert mm.LAUNCHES["g1_fused_madd"] == before + 1
        assert all(map(torch.equal, got, expected))


def test_madd_accumulate_reads_a_strided_start(cuda):
    """A starting accumulator of sliced views (row stride 2n) and of
    transposed copies (row stride 1, column stride 24)."""
    from simpleworks_tpu_torch.ops import g1_fused

    n = 300
    ins, rows, idx, valid = accumulate_grid(n, 4, 17, cuda)
    expected = g1_fused.madd_accumulate_plain(ins["p3"], rows, idx, valid)
    sliced = tuple(torch.cat([a, a], dim=1)[:, n:] for a in ins["p3"])
    transposed = tuple(a.t().contiguous().t() for a in ins["p3"])
    for start in (sliced, transposed):
        assert all(map(torch.equal, g1_fused.madd_accumulate(start, rows, idx, valid), expected))


def test_madd_accumulate_rejects_bad_inputs(cuda):
    from simpleworks_tpu_torch.ops import g1_fused

    ins, rows, idx, valid = accumulate_grid(8, 2, 18, cuda)
    with pytest.raises(ValueError):  # not contiguous
        g1_fused.madd_accumulate(None, rows, idx.t().contiguous().t(), valid)
    with pytest.raises(ValueError):  # the rows not 16-byte aligned
        flat = torch.empty(8 * 48 + 1, dtype=torch.int32, device=cuda)
        g1_fused.madd_accumulate(None, flat[1:].view(8, 48), idx, valid)
    with pytest.raises(ValueError):  # a CPU grid for a card table
        g1_fused.madd_accumulate(None, rows, idx.cpu(), valid.cpu())


def combine_sums(w_count, segs, b, seed, device, pool=8192):
    """Bucket sums of a (W, S, b) grid: the p3 lanes of g1_inputs (the lane
    cases of G1_CASES among seed-made points), repeated past ``pool``
    lanes."""
    from chip_smoke import g1_inputs

    lanes = w_count * segs * b
    ins = g1_inputs(min(lanes, pool), seed, device)
    reps = -(-lanes // pool)
    return tuple(a.repeat(1, reps)[:, :lanes].contiguous() for a in ins["p3"])


@pytest.mark.parametrize("w_count,segs,b", [(1, 1, 2), (1, 4, 2), (3, 1, 8), (2, 8, 32),
                                            (5, 2, 64), (19, 1, 256)])
def test_bucket_combine_matches_plain(cuda, w_count, segs, b):
    """The combine kernel against the plain version, one launch counted per
    call."""
    from simpleworks_tpu_torch.ops import g1_fused

    acc = combine_sums(w_count, segs, b, 20 + b, cuda)
    expected = g1_fused.bucket_combine_plain(acc, w_count, segs, b)
    before = mm.LAUNCHES["g1_bucket_combine"]
    got = g1_fused.bucket_combine(acc, w_count, segs, b)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["g1_bucket_combine"] == before + 1
    assert all(map(torch.equal, got, expected))


def test_bucket_combine_grid_stride_rounds(cuda):
    """A grid whose widest step (the fold's 2^17 lanes) and suffix steps
    have more lanes than the card holds resident threads, so each step's
    grid-stride loop runs more than one round."""
    from simpleworks_tpu_torch.ops import g1_fused

    w_count, segs, b = 4096, 2, 32
    # an SM holds at most 65,536 registers' worth of threads
    registers = g1_fused.kernel_resources()["g1_bucket_combine"]["registers"]
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert w_count * b > sms * (65536 // registers)
    acc = combine_sums(w_count, segs, b, 21, cuda)
    got = g1_fused.bucket_combine(acc, w_count, segs, b)
    assert all(map(torch.equal, got, g1_fused.bucket_combine_plain(acc, w_count, segs, b)))


def test_bucket_combine_rejects_bad_inputs(cuda):
    from simpleworks_tpu_torch.ops import g1_fused

    acc = combine_sums(2, 2, 4, 22, cuda)
    with pytest.raises(ValueError):  # not contiguous
        g1_fused.bucket_combine(tuple(a.t().contiguous().t() for a in acc), 2, 2, 4)
    with pytest.raises(ValueError):  # planes on two devices
        g1_fused.bucket_combine((acc[0], acc[1], acc[2].cpu()), 2, 2, 4)
    with pytest.raises(ValueError):  # one bucket a window
        g1_fused.bucket_combine(acc, 8, 2, 1)


def fixed_base_inputs(n, seed, device):
    """The generator's packed window table, and [16, n] limbs of
    chip_smoke.fixed_base_crafted's scalars (0, 1, r − 1, one digit a
    window, 255 below the top; past r the top window's cancelling and
    doubling sums) followed by seed-made 256-bit values."""
    from chip_smoke import fixed_base_crafted
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.fields.device import ints_to_limbs
    from simpleworks_tpu_torch.ops import srs_device

    rng = np.random.default_rng(seed)
    scalars = (fixed_base_crafted() + [int.from_bytes(rng.bytes(32), "little")
                                       for _ in range(n)])[:n]
    std = torch.from_numpy(ints_to_limbs(scalars, 16).astype(np.int32)).to(device)
    return srs_device._packed_table(G1Point.generator(), device), std


@pytest.mark.parametrize("n", [1, 33, 4099])
def test_fixed_base_matches_plain(cuda, n):
    """The fixed-base kernel against its plain lane walk, one launch counted
    per call."""
    from simpleworks_tpu_torch.ops import g1_fused

    table, std = fixed_base_inputs(n, 30, cuda)
    expected = g1_fused.fixed_base_plain(table, std)
    before = mm.LAUNCHES["g1_fixed_base"]
    got = g1_fused.fixed_base(table, std)
    torch.cuda.synchronize()
    assert mm.LAUNCHES["g1_fixed_base"] == before + 1
    assert all(map(torch.equal, got, expected))


def test_fixed_base_reads_strided_scalars(cuda):
    """Scalar limb rows sliced from a wider tensor (row stride 2n), every
    second column (column stride 2) and transposed (row stride 1, column
    stride 16)."""
    from simpleworks_tpu_torch.ops import g1_fused

    n = 300
    table, std = fixed_base_inputs(n, 31, cuda)
    expected = g1_fused.fixed_base_plain(table, std)
    sliced = torch.cat([std, std], dim=1)[:, n:]
    every_second = torch.stack([std, std], dim=2).reshape(16, 2 * n)[:, ::2]
    transposed = std.t().contiguous().t()
    for view in (sliced, every_second, transposed):
        assert not view.is_contiguous()
        assert all(map(torch.equal, g1_fused.fixed_base(table, view), expected))


def test_fixed_base_rejects_bad_inputs(cuda):
    from simpleworks_tpu_torch.ops import g1_fused

    table, std = fixed_base_inputs(8, 32, cuda)
    flat = torch.empty(table.numel() + 1, dtype=torch.int32, device=cuda)
    before = mm.LAUNCHES["g1_fixed_base"]
    for args in ((table[:, :35], std),              # a row of 35 words
                 (table.to(torch.int64), std),      # not int32
                 (table, std[:15]),                 # 15 limb rows
                 (table, std.to(torch.int64)),      # int64 limbs
                 (table.cpu(), std),                # a CPU table for card scalars
                 (flat[1:].view(table.shape), std),  # rows not 16-byte aligned
                 (table.t().contiguous().t(), std)):  # rows not contiguous
        with pytest.raises(ValueError):
            g1_fused.fixed_base(*args)
    assert mm.LAUNCHES["g1_fixed_base"] == before


def test_fixed_base_kernel_resources(cuda):
    from simpleworks_tpu_torch.ops import g1_fused

    res = g1_fused.kernel_resources()["g1_fixed_base"]
    assert 0 < res["registers"] <= 255 and res["local_bytes"] >= 0


def test_default_device_is_the_card(cuda):
    from simpleworks_tpu_torch.device import default_device, resolve
    from simpleworks_tpu_torch.fields import dvec

    assert default_device().type == "cuda"
    x = dvec.from_ints([1, 2, 3])
    assert x.device.type == "cuda"
    # "cuda" without an index resolves to the card a tensor reports
    assert resolve(cuda) == resolve(None) == x.device
    assert dvec.to_ints(dvec.ifft(dvec.fft(x[:, :2], 2), 2)) == [1, 2]

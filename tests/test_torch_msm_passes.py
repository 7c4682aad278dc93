"""The MSM's memory-bounded schedule on the CPU: passes forced by a small
budget give the one-pass result and the plain reference's [p(tau)]G; the
int32 grid is the int64 grid it replaced, index for index; the budget asks
the card's free memory only when the plan may not fit; digits at every
width the schedule takes; the setup's lane passes; the spans.  The full MSM
at the large-n width (2^16 buckets a window) runs only on the card (marker
``cuda``): its combine's plain version would take hours here."""

import numpy as np
import pytest
import torch

from benchmark.lib import seeds
from benchmark.reference import field, g1, kzg
from simpleworks_tpu_torch.curves.bls12_377 import G1Point
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.ops import g1_limb, msm_pippenger as mp, srs_device
from simpleworks_tpu_torch.utils.observability import PROVER_TIMER

torch.set_num_threads(1)
CPU = torch.device("cpu")
N = 1 << 12
SEED = 2**31 + 20


@pytest.fixture(autouse=True)
def _no_disk_checkpoints(monkeypatch):
    monkeypatch.setenv("SWTPU_SRS_DISK_CACHE", "0")


def ring_poly(n, seed, device=CPU):
    """[16, n] Montgomery limbs drawn as the benchmark's commit kind draws them."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    poly = torch.randint(0, 1 << 16, (16, n), dtype=torch.int32, generator=gen, device=device)
    poly[15] %= field.R >> 240
    return poly


def srs_and_tau(max_degree, device=CPU):
    srs = kzg10.setup(max_degree, seeds.WordStream(SEED, "srs"), device=device)
    tau, _ = kzg.setup_scalars(seeds.WordStream(SEED, "srs").next_u64)
    return srs, tau


def expected(poly, tau):
    return kzg.commitment(poly.cpu().numpy(), kzg.power_limbs(tau, poly.shape[1]))


def passes(n, poly, c, budget, lanes):
    _, stats = mp.mont_digits(poly, c)
    per_window = [(w, int(o), max(int(m), 1)) for w, (o, m) in enumerate(stats.tolist())]
    return mp.plan_passes(per_window, n, lanes, budget)


def forcing_budget(n, poly, c, lanes):
    """A budget that cuts the widest group into at least two passes."""
    metas = passes(n, poly, c, 1 << 62, lanes)
    widest = max(metas, key=lambda m: len(m[0]))
    return mp.pass_bytes(n, len(widest[0]), *widest[1:]) // 3


@pytest.fixture(scope="module")
def table():
    return srs_and_tau(N - 1)


def test_passes_equal_one_pass_and_the_reference(table, monkeypatch):
    srs, tau = table
    poly = ring_poly(N, 1)
    budget = forcing_budget(N, poly, 8, mp.target_lanes(CPU))
    assert len(passes(N, poly, 8, budget, mp.target_lanes(CPU))) >= 3
    assert len(passes(N, poly, 8, mp.memory_budget(CPU, 0), mp.target_lanes(CPU))) == 2
    whole = mp.msm_device_mont(srs.powers_xy, poly, c=8)
    monkeypatch.setattr(mp, "memory_budget", lambda device, need: budget)
    got = mp.msm_device_mont(srs.powers_xy, poly, c=8)
    assert got == whole
    assert g1.equal((got.X, got.Y, got.Z), expected(poly, tau))


class FakeCard:
    """torch.cuda's memory calls for an 80 GB card holding ``allocated``
    bytes, counting the device queries."""

    def __init__(self, allocated, free):
        self.allocated, self.free, self.queries = allocated, free, 0

    def install(self, monkeypatch):
        props = type("Props", (), {"total_memory": 80 << 30})()
        monkeypatch.setattr(torch.cuda, "get_device_properties", lambda device: props)
        monkeypatch.setattr(torch.cuda, "memory_allocated", lambda device: self.allocated)
        monkeypatch.setattr(torch.cuda, "memory_reserved", lambda device: self.allocated + (2 << 30))
        monkeypatch.setattr(torch.cuda, "mem_get_info", self.mem_get_info)

    def mem_get_info(self, device):
        self.queries += 1
        return self.free, 80 << 30


@pytest.mark.parametrize("allocated, need, queries, budget", [
    (4 << 30, 1 << 30, 0, 1 << 30),              # a 2^20 commit: no query
    (34 << 30, 30 << 30, 1, (30 + 2 - 10) << 30),  # 2^26: free + cached - an eighth
    (70 << 30, 1 << 30, 1, 0),                   # a full card: asked, nothing left
])
def test_the_budget_asks_the_card_only_when_the_plan_may_not_fit(monkeypatch, allocated, need,
                                                                 queries, budget):
    card = FakeCard(allocated, max(0, (80 << 30) - allocated - (16 << 30)))
    card.install(monkeypatch)
    assert mp.memory_budget(torch.device("cuda", 0), need) == budget
    assert card.queries == queries


@pytest.mark.parametrize("c", [8, mp.LARGE_WINDOW_BITS])
def test_the_passes_grids_are_the_one_pass_grid(c):
    """Cut into passes, every window's grid (its columns, lane for lane) is
    the one it has in the one-pass grid."""
    poly = ring_poly(N, c)
    lanes = mp.target_lanes(CPU)
    digits, _ = mp.mont_digits(poly, c)

    def columns(metas):
        """Window -> (digits, points) of its valid lanes in the order its
        buckets add them: by digit, then by rank s·D + r."""
        out = {}
        for window_ids, segs, b_g, depth in metas:
            idx, valid = mp.device_grid_from_digits(digits[window_ids], depth, segs, b_g, 3)
            idx = idx.reshape(depth, len(window_ids), segs, b_g)
            valid = valid.reshape(depth, len(window_ids), segs, b_g)
            row = torch.arange(depth).reshape(depth, 1, 1)
            seg = torch.arange(segs).reshape(1, segs, 1)
            dig = torch.arange(b_g).reshape(1, 1, b_g).expand(depth, segs, b_g)
            key = dig * (segs * depth) + seg * depth + row
            for slot, w in enumerate(window_ids):
                v = valid[:, slot]
                order = key[v].argsort()
                out[w] = (dig[v][order].tolist(), idx[:, slot][v][order].tolist())
        return out

    budget = forcing_budget(N, poly, c, lanes)
    cut = passes(N, poly, c, budget, lanes)
    assert len(cut) >= 3
    assert all(mp.pass_bytes(N, len(m[0]), *m[1:]) <= budget for m in cut)
    whole = passes(N, poly, c, 1 << 62, lanes)
    assert sorted(w for m in cut for w in m[0]) == list(range(digits.shape[0]))
    assert columns(cut) == columns(whole)


def test_a_window_that_does_not_fit_raises():
    poly = ring_poly(256, 3)
    with pytest.raises(MemoryError, match="budget"):
        passes(256, poly, 8, 1000, 1024)


def old_int64_grid(digits_g, depth, segs, b, offset):
    """The grid as it was built before the passes: int64 digits, a full
    argsort, searchsorted starts, a gather and a permuted copy."""
    digits_g = digits_g.to(torch.int64)
    g, n = digits_g.shape
    order = torch.argsort(digits_g, dim=1, stable=True)
    sorted_d = torch.gather(digits_g, 1, order)
    targets = torch.arange(b + 1, dtype=torch.int64).expand(g, b + 1).contiguous()
    starts = torch.searchsorted(sorted_d, targets)
    counts = starts[:, 1:] - starts[:, :-1]
    row = torch.arange(depth).reshape(1, depth, 1, 1)
    seg = torch.arange(segs).reshape(1, 1, segs, 1)
    dig = torch.arange(b).reshape(1, 1, 1, b)
    k = seg * depth + row
    pos = (starts[:, :-1].reshape(g, 1, 1, b) + k).clamp(0, n - 1)
    valid = (k < counts.reshape(g, 1, 1, b)) & (dig > 0)
    idx = torch.gather(order, 1, pos.reshape(g, -1)).reshape(g, depth, segs, b) + offset
    idx = idx.permute(1, 0, 2, 3).reshape(depth, g * segs * b)
    valid = valid.expand(g, depth, segs, b).permute(1, 0, 2, 3).reshape(depth, g * segs * b)
    return idx, valid


@pytest.mark.parametrize("c", [4, 7, 13])
def test_int32_grid_is_the_int64_grid(c):
    n = 300
    digits, stats = mp.mont_digits(ring_poly(n, 40 + c), c)
    assert digits.dtype == torch.int32
    per_window = [(w, int(o), max(int(m), 1)) for w, (o, m) in enumerate(stats.tolist())]
    for window_ids, segs, b_g, depth in mp._meta_from_stats(per_window, 64):
        new = mp.device_grid_from_digits(digits[window_ids], depth, segs, b_g, 5)
        old = old_int64_grid(digits[window_ids], depth, segs, b_g, 5)
        assert new[0].dtype == torch.int64 and new[1].dtype == torch.bool
        assert torch.equal(new[0], old[0]) and torch.equal(new[1], old[1])


@pytest.mark.parametrize("c", [5, 8, 13, 16, 17, 20])
def test_digits_rebuild_their_scalars(c):
    poly = ring_poly(64, c)
    digits, stats = mp.mont_digits(poly, c)
    assert digits.shape == ((256 + c - 1) // c, 64)
    std = [sum(int(v) << (16 * k) for k, v in enumerate(col))
           for col in dvec.to_standard(poly).t().tolist()]
    for i, s in enumerate(std):
        assert sum(int(digits[w, i]) << (w * c) for w in range(digits.shape[0])) == s
    assert stats[:, 1].max() < 1 << c


def test_large_window_width():
    assert mp._auto_window_bits(1 << 20) == 13
    assert mp._auto_window_bits((1 << 20) + 1) == 13
    assert mp._auto_window_bits(mp.LARGE_WINDOW_POINTS - 1) == 13
    assert mp._auto_window_bits(mp.LARGE_WINDOW_POINTS) == mp.LARGE_WINDOW_BITS
    assert mp._auto_window_bits(1 << 26) == mp.LARGE_WINDOW_BITS


def test_setup_in_lane_passes_is_one_pass(monkeypatch):
    scalars = [0, 1, field.R - 1] + [pow(7, i, field.R) for i in range(37)]
    std = torch.from_numpy(np.array(
        [[(s >> (16 * k)) & 0xFFFF for k in range(16)] for s in scalars], dtype=np.int32).T.copy())
    g = G1Point.generator()
    whole = g1_limb.normalize_affine(srs_device.fixed_base_powers_device(g, std))
    monkeypatch.setattr(srs_device, "SETUP_CHUNK", 16)
    planes = srs_device.fixed_base_powers_affine(g, std)
    assert torch.equal(planes, whole)
    # the planes are a view of the row-major table the accumulate reads
    assert g1_limb.table_rows(planes).data_ptr() == planes.data_ptr()


def test_the_srs_is_row_major(table):
    srs, _ = table
    rows = g1_limb.table_rows(srs.powers_xy)
    assert rows.shape == (N, 48) and rows.data_ptr() == srs.powers_xy.data_ptr()


def test_spans_fire_once_a_stage_and_a_pass(table):
    srs, _ = table
    poly = ring_poly(100, 9)
    PROVER_TIMER.reset()
    metas = passes(100, poly, 4, mp.CPU_BUDGET, mp.target_lanes(CPU))
    mp.msm_device_mont(srs.powers_xy, poly, c=4)
    assert PROVER_TIMER.counts == {"msm.digits": 1, "msm.grid": len(metas),
                                   "msm.accumulate": len(metas), "msm.combine": len(metas),
                                   "msm.fold": 1}
    PROVER_TIMER.reset()


@pytest.mark.cuda
def test_large_width_passes_on_the_card(monkeypatch):
    """On the card: at the large-n width, passes forced by a small budget
    give the one-pass result and the reference."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with pytest -m cuda")
    card = torch.device("cuda", 0)
    n = 1 << 16
    srs, tau = srs_and_tau(n - 1, card)
    poly = ring_poly(n, 5, card)
    c = mp.LARGE_WINDOW_BITS
    budget = forcing_budget(n, poly, c, mp.target_lanes(card))
    assert len(passes(n, poly, c, budget, mp.target_lanes(card))) >= 3
    whole = mp.msm_device_mont(srs.powers_xy, poly, c=c)
    monkeypatch.setattr(mp, "memory_budget", lambda device, need: budget)
    got = mp.msm_device_mont(srs.powers_xy, poly, c=c)
    assert got == whole
    assert g1.equal((got.X, got.Y, got.Z), expected(poly, tau))

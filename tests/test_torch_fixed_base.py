"""The setup's fixed-base powers (simpleworks_tpu_torch.ops.g1_fused.fixed_base,
whose CUDA kernel walks all 32 windows of a lane in one launch) held against
the JAX package's host runtime, exactly: the plain lane walk over the packed
window table, on the CPU, against ``native.g1_fixed_base_raw``'s Jacobian
words, which the reference's own device route equals
(tests/test_msm_device.py); and against the per-window route it replaced.

The reference's jitted fixed base (simpleworks_tpu/ops/srs_device.py) is not
run here: its CPU compile takes ~9 s, for one program the native runtime
already pins."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import fixed_base_crafted
from simpleworks_tpu import native
from simpleworks_tpu.curves import bls12_377 as ref_curves
from simpleworks_tpu_torch.curves.bls12_377 import G1Point
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.device import ints_to_limbs
from simpleworks_tpu_torch.ops import _build, g1_fused, g1_limb, srs_device

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

G = G1Point.generator()


def limbs(scalars) -> torch.Tensor:
    return torch.from_numpy(ints_to_limbs(scalars, 16).astype(np.int32))


def reference_planes(scalars) -> torch.Tensor:
    """The JAX package's native fixed base as [3, 24, N] Montgomery limbs."""
    raw = native.g1_fixed_base_raw(ref_curves.G1Point.generator(), scalars)  # [N, 18] u64
    planes = np.ascontiguousarray(raw).view("<u2").reshape(-1, 3, 24).transpose(1, 2, 0)
    return torch.from_numpy(planes.astype(np.int32)), raw


def layout(std: torch.Tensor, name: str) -> torch.Tensor:
    """The scalar limb rows as a dense tensor, a slice of a wider one (row
    stride 4N, column stride 2) or a transposed copy (row stride 1, column
    stride 16)."""
    n = std.shape[1]
    if name == "strided":
        wide = torch.zeros((16, 4 * n), dtype=torch.int32)
        wide[:, n::2][:, :n] = std
        return wide[:, n::2][:, :n]
    if name == "transposed":
        return std.t().contiguous().t()
    return std


@pytest.fixture(scope="module")
def table():
    return srs_device._packed_table(G, CPU)


@pytest.mark.parametrize("name", ["dense", "strided", "transposed"])
def test_lane_walk_matches_reference_jacobian(table, name, monkeypatch):
    """On chip_smoke's crafted scalars (below r: 0, 1, r − 1, one digit in
    each window, 255 below the top; past r: 2^256 − 1 and the top window's
    cancelling and doubling sums) the wrapper on CPU tensors takes the plain
    lane walk (the kernel's launch is never reached) and gives the
    reference's Jacobian words; the affine planes after normalize_affine
    equal its normalised rows."""
    scalars = fixed_base_crafted()
    std = layout(limbs(scalars), name)
    assert name == "dense" or not std.is_contiguous()

    def no_launch(*args):
        raise AssertionError("a CPU tensor launched the kernel")

    monkeypatch.setattr(g1_fused, "_launch_fixed_base", no_launch)
    before = _build.LAUNCHES["g1_fixed_base"]
    jac = srs_device.fixed_base_powers_device(G, std)
    assert _build.LAUNCHES["g1_fixed_base"] == before
    expected, raw = reference_planes(scalars)
    assert torch.equal(torch.stack(jac), expected)
    if name == "dense":
        affine = g1_limb.normalize_affine(jac)
        assert torch.equal(affine, g1_limb.native_points_to_limb_major(
            native.g1_normalize_arr(raw), CPU))


def test_lane_walk_matches_per_window_route(table):
    """The plain lane walk against the route it replaced (one plain add a
    window from the identity) and the host point law, on random 256-bit
    scalars and the crafted ones past r."""
    rng = np.random.default_rng(41)
    scalars = [int.from_bytes(rng.bytes(32), "little") for _ in range(5)] + \
        fixed_base_crafted()[-7:]
    std = limbs(scalars)
    got = g1_fused.fixed_base(table, std)
    route = srs_device.fixed_base_per_window(G, std)
    assert all(map(torch.equal, got, route))
    assert g1_limb.points_from_limb_major(got) == [G.scalar_mul(s % P) for s in scalars]


def test_packed_table_round_trips(table):
    """pack_table of the window planes is the kernel's row layout (word k of
    a coordinate holds limbs 2k and 2k + 1) and unpacks to the same planes,
    limbs with the top bit set included."""
    planes = srs_device._table_planes(G, CPU)
    assert table.shape == (8192, 36) and table.dtype == torch.int32 and table.is_contiguous()
    assert torch.equal(g1_fused.unpack_table(table), planes)
    words = table.to(torch.int64) & 0xFFFFFFFF
    row = 256 * 5 + 77
    for c in range(3):
        for k in range(12):
            assert int(words[row, 12 * c + k]) == \
                int(planes[c, 2 * k, row]) | int(planes[c, 2 * k + 1, row]) << 16
    rng = np.random.default_rng(42)
    wild = torch.from_numpy(rng.integers(0, 1 << 16, size=(3, 24, 40)).astype(np.int32))
    wild[:, :, 0] = 0xFFFF
    assert torch.equal(g1_fused.unpack_table(g1_fused.pack_table(wild)), wild)


def test_fixed_base_rejects_bad_inputs(table):
    std = limbs([1, 2, 3])
    bad = [
        (table[:, :35], std),                       # a row of 35 words
        (table[:4096], std),                        # half the windows
        (table.to(torch.int64), std),               # not int32
        (table, std[:15]),                          # 15 limb rows
        (table, std.to(torch.int64)),               # int64 limbs
        (table, std[0]),                            # one dimension
        (table, torch.empty_like(std, device="meta")),  # another device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            g1_fused.fixed_base(*args)

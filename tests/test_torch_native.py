"""The port's binding of the host native runtime (simpleworks_tpu_torch/native)
held against the JAX package's pure functions, and each native route of the
port held against the port's plain route on the same CPU tensors.  The
runtime's source is the JAX package's, byte for byte.  Tolerance 0: equal
integers, group elements and tensors."""

import os
import random
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from simpleworks_tpu.curves.bls12_377 import G1Point as RefG1
from simpleworks_tpu.kzg.msm import msm as ref_msm
from simpleworks_tpu.ops import msm_pippenger as ref_pippenger
from simpleworks_tpu.poly.domain import Radix2Domain as RefDomain
from simpleworks_tpu.poly.domain import ntt_host as ref_ntt_host
from simpleworks_tpu_torch import native
from simpleworks_tpu_torch.curves.bls12_377 import G1Point
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FQ_MODULUS, FR_MODULUS, fr_root_of_unity
from simpleworks_tpu_torch.fields.frvec import FrVec, SpmvPlan
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.ops import _build, g1_limb, msm_pippenger
from simpleworks_tpu_torch.ops.msm_pippenger import msm_device_mont
from simpleworks_tpu_torch.parallel import msm_sharded

os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parent.parent
CPU = torch.device("cpu")
P = FR_MODULUS
rnd = random.Random(99)

pytestmark = pytest.mark.skipif(not native.available(), reason="no C++ compiler on PATH")


@pytest.fixture(autouse=True, scope="module")
def _no_disk_checkpoints():
    """The SRS checkpoint off: every setup of this file is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_SRS_DISK_CACHE", "0")
        yield


def plain(monkeypatch, fn):
    """``fn()`` with the native runtime turned off (the plain route)."""
    with monkeypatch.context() as mp:
        mp.setenv("SWTPU_NATIVE", "0")
        return fn()


def ref_points(n: int, start: int = 2) -> list:
    g = RefG1.generator()
    return [g.scalar_mul(i + start) for i in range(n)]


def port_point(p) -> G1Point:
    return G1Point.identity() if p.is_identity() else G1Point(p.X, p.Y, p.Z)


def multiples(n: int, start: int) -> list:
    """start·G .. (start + n − 1)·G, by the native fixed base (checked
    against scalar_mul in test_native_fixed_base)."""
    return native.g1_fixed_base(G1Point.generator(), list(range(start, start + n)))


def seeded(n: int, seed: int) -> list[int]:
    r = np.random.default_rng(seed)
    return [int.from_bytes(r.bytes(32), "little") % P for _ in range(n)]


# ------------------------------------------------------- source and build ----


def test_source_is_the_reference_source():
    assert (ROOT / "simpleworks_tpu_torch/csrc/host_native.cpp").read_bytes() == \
        (ROOT / "csrc/swtpu_native.cpp").read_bytes()


def test_library_builds_into_the_ignored_build_dir(monkeypatch):
    lib = native._lib()
    path = Path(lib._name)
    assert path.parent == _build.BUILD_DIR and path.name.startswith("libhost_native_")
    assert path.name == _build._host_library_path(_build.CSRC / "host_native.cpp").name
    assert "-march=native" in _build.HOST_CXX_FLAGS
    assert native.available()
    monkeypatch.setenv("SWTPU_NATIVE", "0")
    assert not native.available()


def test_a_failing_compiler_raises(tmp_path):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    with pytest.raises(RuntimeError, match="failed on broken.cpp"):
        _build.build_host(bad, native.compiler())
    assert not list(_build.BUILD_DIR.glob("libbroken_*"))


# ------------------------------------------- tests/test_native.py's cases ----


@pytest.mark.parametrize("field,p", [("fr", FR_MODULUS), ("fq", FQ_MODULUS)])
def test_native_fp_mul(field, p):
    a = [rnd.randrange(p) for _ in range(64)] + [0, 1, p - 1]
    b = [rnd.randrange(p) for _ in range(64)] + [p - 1, p - 1, p - 1]
    assert native.fp_mul_batch(field, a, b) == [x * y % p for x, y in zip(a, b)]


@pytest.mark.parametrize("n", [8, 256])
def test_native_ntt_matches_host(n):
    values = [rnd.randrange(P) for _ in range(n)]
    domain = RefDomain(n)
    got = native.ntt_fr(values, domain.group_gen)
    assert got == ref_ntt_host(values, domain.group_gen)
    back = native.ntt_fr(got, domain.group_gen_inv, scale=domain.size_inv)
    assert back == values


def test_native_msm_matches_python(monkeypatch):
    points = ref_points(50, start=1)
    scalars = [rnd.randrange(P) for _ in range(50)]
    got = native.g1_msm([port_point(p) for p in points], scalars)
    expected = plain(monkeypatch, lambda: ref_msm(points, scalars))  # the pure Pippenger
    assert got.serialize_compressed() == expected.serialize_compressed()


def test_native_fixed_base():
    g = G1Point.generator()
    scalars = [1, 2, 255, 256, 257, rnd.randrange(P)]
    for s, p in zip(scalars, native.g1_fixed_base(g, scalars)):
        assert p == g.scalar_mul(s)


def test_native_combine_and_horner():
    polys = [([rnd.randrange(P) for _ in range(20)], rnd.randrange(P)),
             ([rnd.randrange(P) for _ in range(35)], rnd.randrange(P))]
    expected = [0] * 35
    for coeffs, w in polys:
        for i, c in enumerate(coeffs):
            expected[i] = (expected[i] + w * c) % P
    assert native.fr_combine(polys) == expected
    coeffs = [rnd.randrange(P) for _ in range(50)]
    z = rnd.randrange(P)
    acc = 0
    for c in reversed(coeffs):
        acc = (acc * z + c) % P
    assert native.fr_horner(coeffs, z) == acc


def test_native_msm_raw_matches(monkeypatch):
    points = ref_points(40)
    scalars = [rnd.randrange(P) for _ in range(40)]
    got = native.g1_msm_raw(native._points_to_native([port_point(p) for p in points]), scalars)
    expected = plain(monkeypatch, lambda: ref_msm(points, scalars))
    assert got.serialize_compressed() == expected.serialize_compressed()


def test_native_msm_affine_matches_jacobian():
    """Batch-affine == Jacobian Pippenger across windows, with zero and unit
    scalars, a repeated point (bucket doubling) and an identity row."""
    g = G1Point.generator()
    n = 200
    points = multiples(n, 2)
    points[5] = points[4]
    scalars = [rnd.randrange(P) for _ in range(n)]
    scalars[0], scalars[1], scalars[3] = 0, 1, scalars[2]
    norm = native.g1_ensure_normalized(native._points_to_native(points).copy())
    norm[7] = 0
    std = native.fr_from_mont_arr(native.limbs_to_words(dvec.from_ints(scalars, CPU)))
    for wb in (2, 8, 13):
        assert native.g1_msm_arr(norm.copy(), std, window_bits=wb) == \
            native.g1_msm_affine_arr(norm, std, window_bits=wb), wb
    assert native.g1_ensure_normalized(norm) is norm


# ------------------------------------------------------------- bridges ----


def test_layout_bridges_round_trip():
    values = seeded(37, 1) + [0, 1, P - 1]
    limbs = dvec.from_ints(values, CPU)
    words = native.limbs_to_words(limbs)
    assert words.shape == (40, 4) and words.dtype == np.dtype("<u8")
    r = 1 << 256
    assert native.limbs64_to_ints(words) == [v * r % P for v in values]
    assert torch.equal(native.words_to_limbs(words), limbs)
    assert native.limbs64_to_ints(native.std_words(limbs)) == values
    # a strided (expanded) tensor reads as its values
    col = dvec.from_ints([5], CPU)
    assert torch.equal(native.words_to_limbs(native.limbs_to_words(col.expand(16, 3))),
                       col.expand(16, 3))


def test_point_bridges_round_trip():
    g = G1Point.generator()
    points = [g.scalar_mul(i + 1) for i in range(6)] + [G1Point.identity()]
    rows = native.g1_normalize_arr(native._points_to_native(points))
    planes = g1_limb.native_points_to_limb_major(rows, CPU)
    assert np.array_equal(native.planes_to_native(planes), rows)
    assert np.array_equal(native.native_to_planes_u16(rows), planes.numpy().astype(np.uint16))
    back = native._points_from_native(rows)
    assert back[:6] == points[:6] and back[6].is_identity()
    x, y, _ = g1_limb.points_to_limb_major_affine(points, CPU)
    assert torch.equal(planes, torch.stack([x, y]))


# ----------------------------------------- native route == plain route ----


@pytest.mark.parametrize("n", [64, 1024])
def test_fft_ifft_routes_agree(monkeypatch, n):
    coeffs = dvec.from_ints(seeded(n - 3, n), CPU)
    evals = dvec.fft(coeffs, n)
    assert torch.equal(evals, plain(monkeypatch, lambda: dvec.fft(coeffs, n)))
    assert dvec.to_ints(evals) == ref_ntt_host(dvec.to_ints(dvec.pad_to(coeffs, n)),
                                               fr_root_of_unity(n))
    back = dvec.ifft(evals, n)
    assert torch.equal(back, plain(monkeypatch, lambda: dvec.ifft(evals, n)))
    assert torch.equal(back, dvec.pad_to(coeffs, n))


def test_frvec_ops_routes_agree(monkeypatch):
    n = 300
    a, b, c = (FrVec.from_ints(seeded(n, s) + [0, 1], CPU) for s in (3, 4, 5))
    z = seeded(1, 6)[0]
    cases = {
        "mul": lambda: (a * b).t, "add": lambda: (a + b).t, "sub": lambda: (a - b).t,
        "scale": lambda: a.scale(z).t, "rsub": lambda: a.rsub_scalar(z).t,
        "inv": lambda: a.inv().t, "mul_add": lambda: a.mul_add(b, c).t,
        "powers": lambda: FrVec.powers(z, n, CPU).t,
        "div_linear": lambda: torch.cat([a.div_linear(z)[0].t,
                                         FrVec.from_ints([a.div_linear(z)[1]], CPU).t], 1),
        "horner": lambda: FrVec.from_ints([a.horner(z)], CPU).t,
        "sum": lambda: FrVec.from_ints([a.sum()], CPU).t,
    }
    for name, fn in cases.items():
        assert torch.equal(fn(), plain(monkeypatch, fn)), name
    assert a.inv().to_ints()[-2:] == [0, 1]


def test_spmv_routes_agree(monkeypatch):
    r = np.random.default_rng(7)
    rows = r.integers(0, 40, size=300)
    cols = r.integers(0, 50, size=300)
    coeffs = FrVec.from_ints(seeded(300, 8), CPU)
    xs = FrVec.from_ints(seeded(150, 9), CPU)
    plan = SpmvPlan(rows, cols, coeffs, 40)
    got = plan.apply_batch(xs.t, 3)
    assert torch.equal(got, plain(monkeypatch, lambda: SpmvPlan(rows, cols, coeffs, 40)
                                  .apply_batch(xs.t, 3)))
    one = FrVec.spmv(rows, cols, coeffs, xs[:50], 40)
    assert torch.equal(one.t, got[:, :40])


def test_msm_routes_agree(monkeypatch):
    g = G1Point.generator()
    points = multiples(70, 3) + [G1Point.identity()]
    x, y, _ = g1_limb.points_to_limb_major_affine(points, CPU)
    planes = torch.stack([x, y])
    coeffs = dvec.from_ints(seeded(60, 10) + [0, 1], CPU)
    got = kzg10.device_msm(planes, coeffs, offset=9)
    assert got == msm_device_mont(planes, coeffs, offset=9)  # the tensor MSM
    assert got == plain(monkeypatch, lambda: kzg10.device_msm(planes, coeffs, offset=9))
    from simpleworks_tpu_torch.kzg.msm import msm as host_pippenger

    scalars = dvec.to_ints(coeffs)
    window = points[9:71]
    assert host_pippenger(window, scalars) == got  # the native branch (≥ 32 pairs)
    assert plain(monkeypatch, lambda: host_pippenger(window, scalars)) == got
    rows = native.planes_to_native(planes)
    std = native.std_words(coeffs)
    assert msm_sharded.sharded_msm_native(["cpu"] * 3, rows, std, offset=9) == got
    assert msm_sharded.sharded_msm(["cpu"] * 3, planes, coeffs, offset=9) == got


def test_setup_routes_agree(monkeypatch):
    """The SRS built by the native fixed base equals the plain tensor build,
    plane for plane, and the commit and batch opening over it agree."""
    from simpleworks_tpu_torch.utils.rng import test_rng

    srs = kzg10.setup(95, test_rng(), device=CPU)
    kzg10._SRS_MEMO.clear()
    srs_plain = plain(monkeypatch, lambda: kzg10.setup(95, test_rng(), device=CPU))
    kzg10._SRS_MEMO.clear()
    assert srs._host_rows is not None and srs_plain._host_rows is None  # built by each route
    assert torch.equal(srs.powers_xy, srs_plain.powers_xy)
    poly = dvec.from_ints(seeded(40, 11), CPU)
    comm = kzg10.commit(srs, poly, degree_bound=60)
    assert comm.serialize() == plain(
        monkeypatch, lambda: kzg10.commit(srs_plain, poly, degree_bound=60)).serialize()
    labeled = [(poly, comm, 0, 60), (dvec.from_ints(seeded(20, 12), CPU), None, 0, None)]
    opened = kzg10.batch_open(srs, labeled, 17, 23)
    assert opened == plain(monkeypatch, lambda: kzg10.batch_open(srs_plain, labeled, 17, 23))


@pytest.mark.parametrize("c", [4, 7])
def test_build_schedule_is_the_device_grid(c):
    """The host-grid oracle equals the grid the device route builds, lane
    for valid lane, and the window counts equal the JAX package's."""
    n = 300
    std = native.std_words(dvec.from_ints(seeded(n, 13 + c) + [0] * 4, CPU))
    digits = msm_pippenger.window_digits(std, c)
    assert np.array_equal(msm_pippenger.window_counts(digits, 1 << c),
                          ref_pippenger.window_counts(digits, 1 << c))
    host = msm_pippenger.build_schedule(std, c, offset=5, lanes=64)
    metas = msm_pippenger.build_schedule_meta(digits, c, 64)
    assert [h[:3] for h in host] == [(m[0], m[1], m[2]) for m in metas]
    for (wids, segs, b_g, idx, valid), (_, _, _, depth) in zip(host, metas):
        d_idx, d_valid = msm_pippenger.device_grid_from_digits(
            torch.from_numpy(digits[wids]), depth, segs, b_g, 5)
        assert np.array_equal(valid, d_valid.numpy())
        assert np.array_equal(idx[valid], d_idx.numpy()[valid])


def test_bad_operands_raise_before_the_call():
    """Shapes and indices are checked in Python before a pointer is passed."""
    a = native.limbs_to_words(dvec.from_ints(seeded(8, 20), CPU))
    with pytest.raises(ValueError):
        native.fr_binop_arr("mul", a, a[:5])
    with pytest.raises(ValueError):
        native.fr_spmv_arr([0, 1], [0, 8], a[:2], a, 4)  # column 8 of 8 inputs
    with pytest.raises(ValueError):
        native.fr_spmv_arr([0, 4], [0, 1], a[:2], a, 4)  # row 4 of 4 outputs
    with pytest.raises(ValueError):
        native.fr_scale_arr(a, a[:2])
    with pytest.raises(ValueError):
        native.fr_ntt_arr(a[:6], fr_root_of_unity(8))
    with pytest.raises(ValueError):
        native.fr_div_linear_arr(a[:0], a[:1])
    with pytest.raises(ValueError):
        native.g1_msm_affine_arr(np.zeros((3, 18), "<u8"), a[:2])


def test_shared_state_under_threads(monkeypatch):
    """Sixteen threads share the runtime's twiddle cache (held to two
    entries, so they evict each other) and one SRS's lazy host rows, with a
    short switch interval: every transform equals the one-thread result and
    every thread gets the one table."""
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point

    monkeypatch.setattr(native, "_NTT_TWIDDLES_MAX", 2)
    sizes = [16, 32, 64, 128]
    inputs = {n: dvec.from_ints(seeded(n, 30 + n), CPU) for n in sizes}
    expected = {n: dvec.fft(inputs[n], n) for n in sizes}
    g = G1Point.generator()
    x, y, _ = g1_limb.points_to_limb_major_affine(multiples(64, 1), CPU)
    srs = kzg10.UniversalSRS(torch.stack([x, y]), None, None, [])
    tables, failures = [], []

    def work(k):
        try:
            for r in range(12):
                n = sizes[(k + r) % len(sizes)]
                if not torch.equal(dvec.fft(inputs[n], n), expected[n]):
                    failures.append(n)
            tables.append(srs.host_powers())
        except Exception as exc:  # noqa: BLE001 - reported by the assertion below
            failures.append(exc)

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(k,)) for k in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert not failures
    assert len(tables) == 16 and all(t is tables[0] for t in tables)

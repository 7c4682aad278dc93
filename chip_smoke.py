#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (simpleworks_tpu_torch) runs on
one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them, and when run outside a checkout of the repository.  Phases, each
printed as one JSON line, any failure raising:

1. the card's name and power limit (nvidia-smi);
2. build: the CUDA field kernels from simpleworks_tpu_torch/csrc/;
3. each kernel against its plain PyTorch version on the card, on seed-made
   inputs with the edge values 0, 1 and p-1 mixed in, at the shapes the main
   path gives it, compared exactly (field arithmetic is exact), and timed;
4. the main path: KZG10 setup at the SRS degree of the Marlin prove of the
   schnorr-verify circuit at SRS(100k, 25k, 300k), four commits of the
   widths that prove commits, a batch opening of all four and the batch
   check (True, then False with one evaluation changed), and a commitment
   held against the host MSM over the SRS points read back;
5. the kernels line: each kernel's launches during phase 4 (every one must
   be > 0), its largest error against the plain version, and both times.

The last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

#: degree of the Marlin SRS for SRS(100k, 25k, 300k): n = 2^17, m = 2^19,
#: max(3n - 1, 3m - 3) (simpleworks_tpu/marlin/ahp.py max_degree_for)
MAX_DEGREE = 1_572_861
#: (name, width, degree bound, hiding) of the commits of phase 4: like the
#: prove's w, g_1 (whose shifted MSM reads the SRS's top) and h_2 at m = 2^18,
#: and one polynomial as wide as the SRS
POLYS = [
    ("w", 1 << 17, None, True),
    ("g_1", (1 << 17) - 1, (1 << 17) - 2, True),
    ("h_2", 3 * (1 << 18) - 2, None, False),
    ("full", MAX_DEGREE + 1, None, False),
]
#: coefficients of the commitment held against the host MSM
HOST_CHECK_WIDTH = 256
#: the c = 13 affine-accumulate lane width of the MSM's uniform bucket group
#: (19 windows x 8192 buckets)
FQ_LANES = 19 * 8192
FR_LANES = 1 << 19

KERNEL_SOURCE = "simpleworks_tpu_torch/csrc/field_kernels.cu"
REPLACES = {
    "mont_mul": "simpleworks_tpu/ops/mont_mul_pallas.py:105",
    "mod_add": "simpleworks_tpu/ops/mont_mul_pallas.py:130",
    "mod_sub": "simpleworks_tpu/ops/mont_mul_pallas.py:154",
    "mont_pow": "simpleworks_tpu/ops/mont_mul_pallas.py:111",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def time_ms(fn, device, reps: int = 5, inner: int = 1, queue_ahead: bool = False) -> float:
    """Median over ``reps`` runs of the mean time of ``inner`` calls, with the
    device synchronised around each run (CUDA events on the card).

    ``queue_ahead``: for a single kernel launch that the host issues more
    slowly than the card runs it, first give the card ~10 ms of spinning so
    that all ``inner`` launches are queued before the start event: the events
    then time the kernels back to back, without the host's launch gaps."""
    import torch

    fn()  # warm-up
    runs = []
    for _ in range(reps):
        sync(device)
        if device.type == "cuda":
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if queue_ahead:
                torch.cuda._sleep(20_000_000)
            start.record()
            for _ in range(inner):
                fn()
            end.record()
            sync(device)
            runs.append(start.elapsed_time(end) / inner)
        else:
            t0 = time.perf_counter()
            for _ in range(inner):
                fn()
            runs.append((time.perf_counter() - t0) * 1e3 / inner)
    return statistics.median(runs)


def field_inputs(field, n: int, seed: int, device):
    """[L, n] limbs of seed-made values < p with 0, 1 and p - 1 in the first
    lanes."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(field.n_limbs, n), dtype=np.int64)
    limbs[-1] %= field.p_limbs[-1]
    edges = [[0] * field.n_limbs, [1] + [0] * (field.n_limbs - 1), list(field.p_limbs)]
    edges[2][0] -= 1
    for j, col in enumerate(edges[:n]):
        limbs[:, j] = col
    return torch.from_numpy(limbs.astype(np.int32)).to(device)


def check_kernels(device, fr_lanes: int = FR_LANES, fq_lanes: int = FQ_LANES,
                  pow_shapes=None) -> dict:
    """Each kernel against its plain version on the same inputs: exact
    equality, and both times."""
    import torch

    from simpleworks_tpu_torch.fields.device import FQ, FR
    from simpleworks_tpu_torch.ops import mont_mul as mm

    results: dict[str, list] = {name: [] for name in REPLACES}

    def record(name, shape, got, plain, ms, plain_ms):
        err = int((got.to(torch.int64) - plain.to(torch.int64)).abs().max()) if got.numel() else 0
        results[name].append({"shape": list(shape), "equal": bool(torch.equal(got, plain)),
                              "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})

    binary = [("mont_mul", mm.mont_mul, mm.mont_mul_plain), ("mod_add", mm.mod_add, mm.mod_add_plain),
              ("mod_sub", mm.mod_sub, mm.mod_sub_plain)]
    for field, lanes in ((FR, fr_lanes), (FQ, fq_lanes)):
        a = field_inputs(field, lanes, 1, device)
        b = field_inputs(field, lanes, 2, device).flip(1).contiguous()  # edges meet others
        for name, op, plain in binary:
            got, ref = op(a, b, field), plain(a, b, field)
            sync(device)
            record(name, a.shape, got, ref,
                   time_ms(lambda: op(a, b, field), device, inner=20, queue_ahead=True),
                   time_ms(lambda: plain(a, b, field), device, reps=3))
    if pow_shapes is None:
        pow_shapes = ((FQ, 512), (FR, 1 << 14))
    for field, lanes in pow_shapes:
        x = field_inputs(field, lanes, 3, device)
        e = field.p - 2  # the Fermat inverse of batch_inverse and dvec.inv
        got, ref = mm.mont_pow(x, e, field), mm.mont_pow_plain(x, e, field)
        sync(device)
        record("mont_pow", x.shape, got, ref,
               time_ms(lambda: mm.mont_pow(x, e, field), device, inner=5, queue_ahead=True),
               time_ms(lambda: mm.mont_pow_plain(x, e, field), device, reps=3))
    for name, rows in results.items():
        for row in rows:
            if not row["equal"]:
                raise AssertionError(f"{name} kernel disagrees with its plain version at {row['shape']}")
    return results


def random_poly(width: int, seed: int, device):
    """[16, width] Montgomery limbs of seed-made Fr values (any value < p is
    a Montgomery representation)."""
    import numpy as np
    import torch

    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS

    rng = np.random.default_rng(seed)
    limbs = rng.integers(0, 1 << 16, size=(16, width), dtype=np.int32)
    limbs[-1] %= FR_MODULUS >> 240
    return torch.from_numpy(limbs).to(device)


def run_slice(device, max_degree: int = MAX_DEGREE, polys=POLYS,
              host_check_width: int = HOST_CHECK_WIDTH) -> dict:
    """setup -> commit -> batch_open -> batch_check through the port's public
    functions; returns the seconds of each step.  Raises on a wrong result."""
    import torch

    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.fields import dvec
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
    from simpleworks_tpu_torch.fields.bls12_377 import Fr
    from simpleworks_tpu_torch.kzg import kzg10
    from simpleworks_tpu_torch.kzg.msm import msm
    from simpleworks_tpu_torch.utils.rng import test_rng

    steps: dict[str, float] = {}

    def timed(name, fn):
        sync(device)
        t0 = time.perf_counter()
        out = fn()
        sync(device)
        steps[name] = time.perf_counter() - t0
        return out

    rng = test_rng()
    srs = timed("setup_s", lambda: kzg10.setup(max_degree, rng, device=device))
    if srs.max_degree != max_degree:
        raise AssertionError(f"SRS degree {srs.max_degree} != {max_degree}")
    tau = Fr.rand(test_rng()).value  # the setup's first draw
    g = G1Point.generator()
    for i in (0, 1, 2, max_degree):
        if srs.power(i) != g.scalar_mul(pow(tau, i, P)):
            raise AssertionError(f"SRS power {i} is not tau^{i} G")

    labeled, rands = [], []
    for seed, (name, width, bound, hiding) in enumerate(polys):
        poly = random_poly(width, seed, device)
        out = timed(f"commit_{name}_s", lambda: kzg10.commit(
            srs, poly, degree_bound=bound, hiding_rng=rng if hiding else None))
        comm, rand = out if hiding else (out, None)
        labeled.append([poly, comm, None, bound])
        rands.append(rand)
    point, xi = Fr.rand(rng).value, Fr.rand(rng).value
    values = timed("evaluate_s", lambda: [dvec.scalar_to_int(dvec.evaluate(p, point))
                                          for p, *_ in labeled])
    for entry, v in zip(labeled, values):
        entry[2] = v
    witness, random_v = timed("batch_open_s", lambda: kzg10.batch_open(
        srs, [tuple(e) for e in labeled], point, xi, rands))

    shift_powers = {b: srs.power(srs.max_degree - b) for *_, b in labeled if b is not None}

    def check(vals):
        return kzg10.batch_check(
            srs.first_power(), srs.h, srs.beta_h, srs.max_degree,
            [(None, comm, v, bound) for (_, comm, _, bound), v in zip(labeled, vals)],
            point, witness, xi, gamma_g=srs.gamma_g, random_v=random_v,
            shift_powers=shift_powers)

    accepted = timed("batch_check_s", lambda: check(values))
    tampered = list(values)
    tampered[0] = (tampered[0] + 1) % P
    rejected = not check(tampered)
    if not (accepted and rejected):
        raise AssertionError(f"batch_check: accepted={accepted}, rejected tampered={rejected}")

    small = random_poly(host_check_width, len(polys), device)
    comm = timed("host_check_commit_s", lambda: kzg10.commit(srs, small))
    expected = msm([srs.power(i) for i in range(host_check_width)], dvec.to_ints(small))
    if comm.comm != expected:
        raise AssertionError("device commitment differs from the host MSM over the SRS")
    return {"max_degree": max_degree, "widths": [w for _, w, _, _ in polys], "steps": steps,
            "batch_check": accepted, "tampered_batch_check": not rejected,
            "host_msm_equal": True}


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    try:
        from simpleworks_tpu_torch.ops import _build, mont_mul
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    print(smi.stdout.strip().splitlines()[0], flush=True)

    t0 = time.perf_counter()
    library = _build.build()
    _build.library()
    emit({"build": {"seconds": time.perf_counter() - t0, "nvcc_seconds": _build.build_seconds,
                    "library": library.name}})

    checks = check_kernels(device)
    emit({"kernel_checks": checks})

    mont_mul.reset_launches()
    torch.cuda.reset_peak_memory_stats(device)
    t0 = time.perf_counter()
    result = run_slice(device)
    launches = dict(mont_mul.LAUNCHES)
    result["seconds"] = time.perf_counter() - t0
    result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
    emit({"slice": result})

    kernels = []
    for name, rows in checks.items():
        main_row = rows[-1]  # the Fq shape for the binary ops, the Fr pow
        kernels.append({
            "name": name, "route": "cuda", "source": KERNEL_SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"], "shape": main_row["shape"],
            "equal": all(r["equal"] for r in rows),
            "shapes": [{k: r[k] for k in ("shape", "ms", "plain_ms")} for r in rows],
        })
    emit({"kernels": kernels})
    idle = [k["name"] for k in kernels if k["launches"] <= 0]
    if idle:
        raise AssertionError(f"kernels never launched on the main path: {idle}")

    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

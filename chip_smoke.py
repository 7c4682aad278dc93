#!/usr/bin/env python3
"""Quickest proof that the PyTorch/CUDA port (simpleworks_tpu_torch) runs on
one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card and the CUDA toolkit (nvcc); exits non-zero without
them, and when run outside a checkout of the repository.  Phases, each
printed as one JSON line, any failure raising:

1. the card's name and power limit (nvidia-smi);
2. build: the CUDA sources of simpleworks_tpu_torch/csrc/, one nvcc each,
   started together, and beside them the host runtime (csrc/host_native.cpp)
   with g++;
3. each field kernel against its plain PyTorch version on the card, on
   seed-made inputs with the edge values 0, 1 and p-1 mixed in, at the
   shapes the main path gives it, compared exactly (field arithmetic is
   exact), and timed;
4. the fused G1 point add and the mixed add (the one-row case of the
   bucket-accumulate kernel) against their plain versions and against the
   composed adds over the field kernels, exactly, at the MSM's lane widths
   [24, 32768] and [24, 155648], on seed-made points with the identities,
   doublings and P + (-P) mixed in, timed; and 2048 lanes against the host
   point law; then the fixed-base kernel (the setup's SRS powers, one
   launch) at the KZG path's width, MAX_DEGREE + 1 = 1,572,862 lanes of
   that setup's scalars: against the per-window route it replaced (one
   gather and one fused-add launch a window, timed in the same call) on
   every lane, against its plain version on the first and last 2^14 lanes,
   and against the host runtime's fixed base on crafted scalars (0, 1,
   r - 1, one nonzero digit in each window, 255 in every window below the
   top; past r, 2^256 - 1 and sums that cancel or double at the top
   window), exactly, with its registers and spills;
5. the NTTs: the limb matmul's reduce kernel (ops/ntt.py, the TPU's route,
   which no path runs) against its plain version on the real first-level
   planes of a seed-made 2^20-point transform (exact); the butterfly NTT
   (poly/ntt_device.py, the route of every transform of the paths): its
   pass kernel against its plain passes and against the stage route, whose
   bit-reversal and stage kernels (no path runs them) are held against
   their plain versions stage by stage, exactly, at 2^20 forward and
   inverse and on the sharded path's column and row batches, the pass
   kernel timed beside the stage route in the same call; the butterfly
   against the pure-Python ntt_host at 2^12 and against the limb matmul at
   2^20 both ways; the round trip ifft(fft(x)) == x at 2^20 through dvec,
   which must launch the pass kernel (two passes a transform) and no other
   NTT kernel; both NTTs' fft and ifft timed at 2^17, 2^19 and 2^20 beside
   their tables' seconds;
   then DeviceField (fields/device.py) on [L, 2^16] Fr and Fq lanes, each op
   against the plain version of its kernel and host integers, and
   curves/g1_device.py: the fixed-base ladder for 256 scalars at 253 bits
   against host scalar_mul, tree_reduce of 2^12 points against the host
   sum;
6. the KZG path: KZG10 setup at the SRS degree of the bench's Marlin prove,
   four commits of the widths that prove commits, a batch opening and the
   batch check (True, then False with one evaluation changed), and a
   commitment held against the host MSM over the SRS points read back;
7. the MSM path: msm_device_mont over that SRS at 2^17 and 2^20 points (the
   bench's MSM legs) under the batch-affine accumulate and under the mixed
   add ("madd", the default: one accumulate-kernel launch a group): equal
   group elements, and the seconds of each; then the accumulate kernel alone
   at the c = 13 group of the 2^20-point MSM (its real depth and 155,648
   lanes) against the plain version (exact), timed, with its registers
   and spills; then the native phase: the host runtime
   (simpleworks_tpu_torch/native; its g++ seconds) against the card,
   exactly: its NTT at 2^16 against the card's,
   its batch-affine MSM against msm_device_mont at 2^16 points of that SRS,
   its fixed base against the SRS's first 2^12 powers; both times, beside
   the host's CPU model and thread count;
8. the chain path: a square-add chain with one public input at n = 2^14
   through universal_setup -> index -> prove (twice) -> verify (True; False
   with one evaluation or the public input changed);
9. the Marlin path: the bench's schnorr-verify circuit (n = 2^17, m = 2^18)
   through universal_setup(100k, 25k, 300k) -> index -> prove (twice) ->
   verify (True; False with one evaluation changed), with the seconds of
   each step, the prover's regions of the warm prove, the proof size and
   the peak device memory; the verifying key and the proof equal, byte for
   byte, the JAX package's host prover on the same draws (the fixture
   tests/torch_fixtures/schnorr_bench_reference.json); the Fermat pow's
   launches counted by caller (dvec.inv and g1_limb.normalize_affine only:
   no accumulate row inverts); then one more warm prove with the
   accumulate forced to "affine", outside the path's counts, which must
   show that it took that route (no accumulate-kernel launch, the pow in
   the affine rows): equal bytes, and its seconds and regions beside the
   madd prove's;
    then the checkpoint path, on the Marlin path's SRS and proving key: both
    saved to the disk checkpoints in a fresh temporary directory (seconds
    and file sizes), then this script started again with
    --checkpoint-child on the same card and directories: its universal_setup
    and index must load both (no SRS build, no index commit, by count), and
    its prove of the bench's circuit on the bench's draws must give the
    fixture's vk and proof; the launches of that process count on the path;
    then the proving-key serde of test_circuit(3, 3) at SRS(32, 32, 64):
    serialize, deserialize onto the card, the same bytes again and the same
    proof;
10. the merkle path: the merkle-tree workload at the reference's parameters
    (SimpleMerkleTree of the example's 8 leaves, Pedersen windows 4x144 /
    4x128, SRS(100k, 25k, 300k): 15,198 constraints, n = 2^14, m = 2^15):
    build, the membership check for leaf 1 (True) and 77 (False), prove
    twice (equal bytes), verify (True for leaf 1, False for 77), with the
    seconds of each step; the root, the verifying key and the proof equal
    the JAX package's (tests/torch_fixtures/merkle_tree_reference.json);
11. the payments path: the simple-payments demo sequence (a transfer
    validated and applied, an overspend, a forged signature, an unknown
    recipient) with the Marlin pipeline of each of its four validates whose
    signature check passes on the card (the schnorr circuit at SRS(100k,
    25k, 300k), each verify True); the verdicts, the balances (5 and 5) and
    the account tree's roots equal the same fixture's;
12. the block path: State.validate_block(prove=True) on a 32-account ledger
    at the reference's parameters and a block of seven transactions (four
    valid transfers from four senders, a forged signature, an overspend, an
    unregistered recipient): the verdicts [T, T, T, T, F, F, F], one
    satisfiability batch of the seven schnorr circuits on the card, one
    SRS(100k, 25k, 300k), and the four proofs indexed and proved in the
    proof pipeline, each verify True, the first and the last equal byte for
    byte to a serial prove; the seconds of each stage and the pipeline's
    overlap;
13. the pipeline path: the demo CLI's proof-pipeline sequence at --full,
    eight manual-constraints circuits proved as a stream and verified;
14. the sharded path: the chain path's circuit proved unsharded and with the
    prover's transforms and commits sharded over the card repeated four
    times: equal bytes, both sharded routes called;
15. the small-prove phase: the reference's wedge circuit
    (manual_constraints.synthesize(5, 5), SRS(100, 25, 300)) set up,
    indexed and proved on the card (launching its kernels) and on the CPU
    (the host native runtime): equal bytes, both warm proves timed;
16. the multihost phase: two processes (this script with
    --multihost-child) join a gloo job on tcp://localhost, each shards the
    sharded path's prove over [cuda:0] * 2 (parallel/multihost.py: a
    global list of 4 devices), and both proofs' bytes equal the sharded
    path's single process's;
17. the card against the CPU: a square-add chain of 5 proved on both
    (the card's side shown there by its launches), equal proof bytes (the
    CPU path is the one the tests hold against the JAX package);
18. the kernels line: each kernel's launches on each path (the counts set to
    0 before the path and read after it; every kernel a path runs must have
    launched there, and the limb matmul's reduce, the stage route's kernels
    and the single fused add on none), its largest error
    against the plain version, its time, the plain version's, and the least
    time the card could take (bound_ms).

The last line is ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --profile

adds, after the kernels line, one warm prove of the schnorr circuit under
torch.profiler: the device's busy share of the prove and its busiest kernels.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from pathlib import Path

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
#: the lane widths of the point adds: a c = 8 group at the card's target
#: row width (msm_pippenger.target_lanes), and the c = 13 group
G1_LANES = (32_768, FQ_LANES)

#: the NTT checks: the reduce kernel, the butterfly's kernels and the round
#: trip at 2^20 (the largest transform of the Marlin path, round 3's 4m),
#: the oracle at 2^12; the butterfly's kernels also on the sharded path's
#: column and row batches of its widest transform (the chain's 4m = 2^17
#: over SHARDS shards); both NTTs timed at the warm prove's sizes (n = 2^17,
#: nq = 4n = 2^19, ne = 4m = 2^20; m = 2^18 runs once)
NTT_LOG = 20
ORACLE_LOG = 12
SHARDED_NTT_LOG = 17
NTT_TIMED_LOGS = (17, 19, 20)
#: the Marlin path: the bench's schnorr-verify circuit (bench.py
#: bench_marlin_prove: 77,012 constraints, no public input beyond the
#: constant, n = 2^17 and m = 2^18) on the bench's SRS (degree 1,572,861)
SRS_SIZES = (100_000, 25_000, 300_000)
MESSAGE = b"a message to sign"
#: the chain path: square-add chain x_{i+1} = x_i^2 + x_i of this many steps
#: plus the input constraint: 16,382 constraints, l = 2 (one public input),
#: 16,384 columns (n = 2^14), m = 2^15, on an SRS sized to it
CHAIN_STEPS = 16_381
CHAIN_SRS_SIZES = (1 << 14, 1 << 14, 1 << 15)
PUBLIC_INPUT = 3
#: the MSM path: msm_device_mont over the KZG path's SRS at the widths of the
#: bench's MSM legs, under both accumulate steps
MSM_LOGS = (17, 20)
#: the card-against-CPU pin: n = 8, m = 16 at SRS(16, 16, 32)
PIN_STEPS = 5
PIN_SRS_SIZES = (16, 16, 32)
#: the JAX package's verifying-key and proof bytes of the Marlin path's
#: prove (tests/test_torch_bench_fixture.py makes and checks the file)
REFERENCE_FIXTURE = Path(__file__).resolve().parent / "tests" / "torch_fixtures" / \
    "schnorr_bench_reference.json"
#: the JAX package's results of the merkle-tree and simple-payments workloads
#: (tests/test_torch_merkle_fixture.py makes and checks the file)
WORKLOAD_FIXTURE = REFERENCE_FIXTURE.parent / "merkle_tree_reference.json"
#: the payments path: the Marlin pipelines each step of the sequence runs.
#: The CLI's sequence runs one at each of the four validates whose native
#: signature check passes, and the path runs all four (26.1 s; the script
#: 212.3 s on the H100, inside its 225 s)
PAYMENTS_PIPELINES = {"sample": 0, "register": 0, "transfer_validate": 1, "transfer_apply": 1,
                      "overspend": 1, "forged_signature": 0, "unknown_recipient": 1}
#: the checkpoint path: the flag that makes this script the path's second
#: process, and how long the first waits for it
CHECKPOINT_CHILD_FLAG = "--checkpoint-child"
CHECKPOINT_CHILD_TIMEOUT_S = 300
#: the serde's circuit, test_circuit(3, 3), at the smallest SRS that indexes
#: it (n = 32, m = 64: degree 189; decompressing its 190 powers takes ~0.5 s)
SERDE_SRS_SIZES = (32, 32, 64)
#: the native phase: the host runtime's NTT and MSM against the card's at
#: these sizes, and its fixed base against the KZG path's first powers
NATIVE_NTT_LOG = 16
NATIVE_MSM_LOG = 16
NATIVE_FIXED_BASE_POWERS = 1 << 12
#: the small-prove phase: the reference's wedge circuit
#: (tests/test_wedge_proof.py), proved on the card and on the host
SMALL_PROVE_SRS_SIZES = (100, 25, 300)
SMALL_PROVE_CIRCUIT = (5, 5)
#: the multihost phase: ranks on the card, each with the card this many times
MULTIHOST_CHILD_FLAG = "--multihost-child"
MULTIHOST_RANKS = 2
MULTIHOST_LOCAL_DEVICES = 2
MULTIHOST_TIMEOUT_S = 300
#: DeviceField's lanes (each op also against host ints on the first ones),
#: the fixed-base ladder's scalars and bits, and tree_reduce's points
DEVICE_FIELD_LANES = 1 << 16
DEVICE_FIELD_HOST_LANES = 1024
LADDER_SCALARS = 256
LADDER_BITS = 253
TREE_POINTS = 1 << 12
#: the block path: a 32-account ledger at the reference's parameters, five
#: accounts registered with BLOCK_BALANCE each, and a block of four valid
#: transfers from four senders, then a signature made with another account's
#: key, an overspend and a transfer to an unregistered account
BLOCK_ACCOUNTS = 32
BLOCK_REGISTERED = 5
BLOCK_BALANCE = 10
BLOCK_VERDICTS = [True, True, True, True, False, False, False]
#: the sharded path: the chain path's circuit proved with the prover's
#: transforms and commits sharded over the card repeated this many times
SHARDS = 4
#: the accumulate check: the c = 13 group of a 2^20-point MSM
ACCUMULATE_LOG = 20
ACCUMULATE_C = 13
#: the combine check: every group of the 2^17-point MSM at the window bits
#: the MSM picks (c = 8), and the accumulate check's group
COMBINE_LOG = 17
#: the fixed-base check: the plain version on the first and the last
#: FIXED_BASE_SLICE lanes of the setup's width
FIXED_BASE_SLICE = 1 << 14
#: the Fr widths of the prove's two dvec.inv (marlin/prover.py): the pow
#: timed there, and checked against its plain version on its first and its
#: last POW_SLICE lanes (the plain pow takes ~0.8 s at that width)
POW_PROVE_LANES = (655_360, 786_432)
POW_SLICE = 1 << 14
#: the pow's first and last POW_HOST_LANES lanes at every shape are also held
#: to host pow(), which shares no code with the kernel's exponent schedule
POW_HOST_LANES = 8

FIELD_SOURCE = "simpleworks_tpu_torch/csrc/field_kernels.cu"
NTT_SOURCE = "simpleworks_tpu_torch/csrc/ntt_kernels.cu"
G1_SOURCE = "simpleworks_tpu_torch/csrc/g1_kernels.cu"
SOURCES = {"mont_mul": FIELD_SOURCE, "mod_add": FIELD_SOURCE, "mod_sub": FIELD_SOURCE,
           "mont_pow": FIELD_SOURCE, "ntt_reduce": NTT_SOURCE, "ntt_bitrev": NTT_SOURCE,
           "ntt_butterfly": NTT_SOURCE, "ntt_pass": NTT_SOURCE,
           "g1_fused_add": G1_SOURCE, "g1_fused_madd": G1_SOURCE,
           "g1_bucket_combine": G1_SOURCE, "g1_fixed_base": G1_SOURCE}
REPLACES = {
    "mont_mul": "simpleworks_tpu/ops/mont_mul_pallas.py:105",
    "mod_add": "simpleworks_tpu/ops/mont_mul_pallas.py:130",
    "mod_sub": "simpleworks_tpu/ops/mont_mul_pallas.py:154",
    "mont_pow": "simpleworks_tpu/ops/mont_mul_pallas.py:111",
    "ntt_reduce": "simpleworks_tpu/ops/ntt_mxu.py:95",
    # no Pallas kernel: the XLA butterfly NTT the reference runs off a TPU,
    # its gather by the bit-reversed indices and its radix-2 stage
    "ntt_bitrev": "simpleworks_tpu/poly/ntt_device.py:81",
    "ntt_butterfly": "simpleworks_tpu/poly/ntt_device.py:82",
    # the whole transform of ntt_device.py:81-90 (bit reversal, stages, 1/n)
    "ntt_pass": "simpleworks_tpu/poly/ntt_device.py:81",
    "g1_fused_add": "simpleworks_tpu/ops/g1_fused_pallas.py:112",
    "g1_fused_madd": "simpleworks_tpu/ops/g1_fused_pallas.py:255",
    # the add kernel, run by the fold and the two suffix passes of
    # simpleworks_tpu/ops/msm_pippenger.py:262-284
    "g1_bucket_combine": "simpleworks_tpu/ops/g1_fused_pallas.py:112",
    # the add kernel once more, run by the setup's scan (SCANS)
    "g1_fixed_base": "simpleworks_tpu/ops/g1_fused_pallas.py:112",
}
#: the reference's scans around a point-add kernel that one launch of the
#: port's kernel runs whole
SCANS = {"g1_fused_madd": "simpleworks_tpu/ops/msm_pippenger.py:251-260",
         "g1_bucket_combine": "simpleworks_tpu/ops/msm_pippenger.py:262-284",
         "g1_fixed_base": "simpleworks_tpu/ops/srs_device.py:54-62"}
#: the kernels that compute in the field alone (check_kernels)
FIELD_KERNELS = ("mont_mul", "mod_add", "mod_sub", "mont_pow")
#: the butterfly NTT's kernels: the pass kernel (every transform of the
#: prover's paths) and the stage route's two, its baseline
BUTTERFLY_KERNELS = ("ntt_bitrev", "ntt_butterfly", "ntt_pass")
#: kernels that no path runs: the limb-matmul NTT's reduce (the reference's
#: MXU route, which it runs only on a TPU) and the stage route's bit reversal
#: and stage (the pass kernel's baseline, timed beside it), held by
#: check_ntt; the single fused add (held by check_g1; the per-window route
#: of the fixed base, which check_fixed_base times, and the batched G1 API
#: run it)
OFF_PATH = ("ntt_reduce", "ntt_bitrev", "ntt_butterfly", "g1_fused_add")
#: Fq products (multiplies, squarings) of one lane of each point add (or of
#: one valid cell of the accumulate, or of one lane of a combine step that
#: runs the add): the general formula (add-2007-bl, madd-2007-bl), and the
#: doubling (dbl-2009-l) that only the lanes needing it run
G1_PRODUCTS = {"g1_fused_add": (11, 5), "g1_fused_madd": (7, 4), "g1_bucket_combine": (11, 5),
               "g1_fixed_base": (11, 5)}
DOUBLE_PRODUCTS = (2, 5)
#: the lane cases of the G1 point-add checks (g1_inputs)
G1_CASES = ("general", "p_identity", "q_identity", "both_identity", "double", "opposite")
#: H100 SXM: device memory rate (bytes/s) and streaming multiprocessors
HBM_BYTES_PER_S = 3.35e12
SMS = 132
#: 32-bit integer multiply-adds an SM issues a clock
IMAD_PER_SM_CLOCK = 64


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


def timed_step(device, steps: dict, name: str, fn):
    """``fn()``, its seconds (the device synchronised around it) into
    ``steps[name]``."""
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    steps[name] = time.perf_counter() - t0
    return out


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


def g1_inputs(n: int, seed: int, device, pool: int = 16) -> dict:
    """Seed-made operands of the G1 point adds over n lanes: p and q as
    Jacobian planes with a random Z per lane, q also as affine planes (the
    identity as x = y = 0).  Lanes 0..5 hold the cases of G1_CASES in order;
    each later lane is one of them at random, "general" (two different
    points of a seed-made pool) 99 times in 100.  Also returns the host
    points and each lane's case."""
    import numpy as np

    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.fields.bls12_377 import FQ_MODULUS as Q
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
    from simpleworks_tpu_torch.fields.device import FQ, to_mont

    rng = np.random.default_rng(seed)
    g = G1Point.generator()
    base = [g.scalar_mul(int.from_bytes(rng.bytes(32), "little") % P).to_affine()
            for _ in range(pool)]
    weights = [0.99] + [0.01 / (len(G1_CASES) - 1)] * (len(G1_CASES) - 1)
    cases = list(G1_CASES[:n]) + list(rng.choice(G1_CASES, size=max(0, n - len(G1_CASES)),
                                                 p=weights))
    first = rng.integers(0, pool, size=n)
    second = (first + 1 + rng.integers(0, pool - 1, size=n)) % pool  # never the first
    z_bytes = rng.bytes(2 * 48 * n)
    z_at = iter(range(0, len(z_bytes), 48))

    def jacobian(xy):
        """Affine (x, y), None the identity -> a Jacobian G1Point of random Z."""
        if xy is None:
            return G1Point.identity()
        at = next(z_at)
        z = int.from_bytes(z_bytes[at : at + 48], "little") % (Q - 1) + 1
        z2 = z * z % Q
        return G1Point(xy[0] * z2 % Q, xy[1] * z2 * z % Q, z)

    ps, qs, affine = [], [], []
    for case, i, k in zip(cases, first, second):
        p, q = base[i], base[k]
        if case in ("p_identity", "both_identity"):
            p = None
        if case in ("q_identity", "both_identity"):
            q = None
        elif case == "double":
            q = p
        elif case == "opposite":
            q = (p[0], (Q - p[1]) % Q)
        ps.append(jacobian(p))
        qs.append(jacobian(q))
        affine.append(q or (0, 0))

    def planes(pts, k):
        return to_mont([(pt.X, pt.Y, pt.Z)[k] for pt in pts], FQ, device)

    return {"p3": tuple(planes(ps, k) for k in range(3)),
            "q3": tuple(planes(qs, k) for k in range(3)),
            "q2": tuple(to_mont([a[k] for a in affine], FQ, device) for k in range(2)),
            "p": ps, "q": qs, "cases": cases}


def check_kernels(device, fr_lanes: int = FR_LANES, fq_lanes: int = FQ_LANES,
                  pow_shapes=None, pow_prove_lanes=POW_PROVE_LANES) -> dict:
    """Each kernel against its plain version on the same inputs: exact
    equality, and both times; the pow also at the prove's widths, checked
    on a slice, and the ends of every pow row against host pow()."""
    import torch

    from simpleworks_tpu_torch.fields.device import FQ, FR, from_mont
    from simpleworks_tpu_torch.ops import mont_mul as mm

    results: dict[str, list] = {name: [] for name in FIELD_KERNELS}

    def check_host_pow(x, got, e, field):
        # the last row's ends against Python's pow on the standard-form values
        k = min(POW_HOST_LANES, x.shape[1])
        lanes = sorted({*range(k), *range(x.shape[1] - k, x.shape[1])})
        want = [pow(v, e, field.p) for v in from_mont(x[:, lanes].cpu(), field)]
        row = results["mont_pow"][-1]
        row["host_lanes"] = len(lanes)
        row["host_equal"] = from_mont(got[:, lanes].cpu(), field) == want

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
        check_host_pow(x, got, e, field)
    for lanes in pow_prove_lanes:
        # the prove's dvec.inv widths: the plain version checks the first and
        # the last POW_SLICE lanes (the last block's too) and is timed, one
        # run, on the first
        x = field_inputs(FR, lanes, 4, device)
        e = FR.p - 2
        got = mm.mont_pow(x, e, FR)
        sync(device)
        t0 = time.perf_counter()
        ref = mm.mont_pow_plain(x[:, :POW_SLICE], e, FR)
        sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        ends = torch.cat([got[:, :POW_SLICE], got[:, -POW_SLICE:]], 1)
        ref = torch.cat([ref, mm.mont_pow_plain(x[:, -POW_SLICE:], e, FR)], 1)
        record("mont_pow", x.shape, ends, ref,
               time_ms(lambda: mm.mont_pow(x, e, FR), device, inner=3, queue_ahead=True),
               plain_ms)
        results["mont_pow"][-1]["plain_shape"] = [FR.n_limbs, POW_SLICE]
        results["mont_pow"][-1]["checked_lanes"] = f"first and last {POW_SLICE}"
        check_host_pow(x, got, e, FR)
        del x, got
    for name, rows in results.items():
        for row in rows:
            if not row["equal"]:
                raise AssertionError(f"{name} kernel disagrees with its plain version at {row['shape']}")
            if not row.get("host_equal", True):
                raise AssertionError(f"{name} kernel disagrees with host pow at {row['shape']}")
    if device.type == "cuda":
        resources = mm.kernel_resources()
        for row in results["mont_pow"]:
            row.update(resources[row["shape"][0] // 2])
    return results


def check_g1(device, widths=G1_LANES) -> dict:
    """Each fused point add against its plain version (exact) and against
    the composed adds over the field kernels (a second witness), on the
    lane cases of g1_inputs at each width, and both times."""
    import torch

    from simpleworks_tpu_torch.ops import g1_fused, g1_limb

    ins = g1_inputs(max(widths), 12, device)
    ops = {"g1_fused_add": (g1_fused.fused_add, g1_fused.fused_add_plain, g1_limb._add_composed,
                            "q3", ("double", "both_identity")),
           "g1_fused_madd": (g1_fused.fused_madd, g1_fused.fused_madd_plain,
                             g1_limb._madd_composed, "q2", ("double",))}
    results: dict[str, list] = {name: [] for name in ops}
    resources = g1_fused.kernel_resources()
    for width in widths:
        p3 = tuple(a[:, :width].contiguous() for a in ins["p3"])
        cases = ins["cases"][:width]
        for name, (op, plain, composed, q_key, dbl_cases) in ops.items():
            q = tuple(a[:, :width].contiguous() for a in ins[q_key])
            got, ref, wit = op(p3, q), plain(p3, q), composed(p3, q)
            sync(device)
            err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
                      for a, b in zip(got, ref))
            row = {"shape": [24, width], "equal": all(map(torch.equal, got, ref)),
                   "composed_equal": all(map(torch.equal, got, wit)), "max_abs_err": err,
                   "double_lanes": sum(c in dbl_cases for c in cases), **resources[name],
                   "ms": time_ms(lambda: op(p3, q), device, inner=20, queue_ahead=True),
                   "plain_ms": time_ms(lambda: plain(p3, q), device, reps=3)}
            if not (row["equal"] and row["composed_equal"]):
                raise AssertionError(f"{name} kernel disagrees at [24, {width}]: {row}")
            results[name].append(row)
    # every lane against the host point law, at a width the host can afford
    few = 2048
    expected = [a.add(b) for a, b in zip(ins["p"][:few], ins["q"][:few])]
    for name, (op, _, _, q_key, _) in ops.items():
        out = op(tuple(a[:, :few] for a in ins["p3"]), tuple(a[:, :few] for a in ins[q_key]))
        if g1_limb.points_from_limb_major(out) != expected:
            raise AssertionError(f"{name} differs from the host point law")
    return results


def fixed_base_crafted() -> list[int]:
    """Scalars for the fixed base against the host: 0, 1, r - 1, one nonzero
    digit in each window (the digit (1 + 37·w mod 255) + 1), 255 in every window
    below the top; then, past r, 2^256 - 1 and those whose walk meets the
    complete add's equal-x cases at the top window: with k the scalar below
    2^248 and d its top digit, m·r (k·G = -d·2^248·G, the sum cancels) and
    2·d·2^248 - m·r for d = ceil(m·r / 2^248) (k·G = d·2^248·G, the sum
    doubles), m = 1, 2, 3."""
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P

    below = [0, 1, P - 1, *(((1 + 37 * w) % 255 + 1) << (8 * w) for w in range(32)),
             (1 << 248) - 1]
    doubling = [2 * (-(-m * P >> 248) << 248) - m * P for m in (1, 2, 3)]
    for s in doubling:  # the part below 2^248 is the top row's point again
        if (s % (1 << 248) - (s >> 248 << 248)) % P:
            raise AssertionError(f"{s:#x} does not double at the top window")
    return below + [(1 << 256) - 1, *(m * P for m in (1, 2, 3)), *doubling]


def fixed_base_work(scalars_std) -> dict:
    """The fixed base's work on these scalars: a lane's first nonzero digit
    adds its row to the identity (no arithmetic), and each later nonzero
    digit adds a row to a point, 16 Fq products; none doubles (below r a
    partial sum k < 2^(8w) never equals, nor cancels, d·2^(8w) < r)."""
    import torch

    digits = torch.stack([(scalars_std[w >> 1] >> (8 * (w & 1))) & 0xFF for w in range(32)])
    nonzero = (digits != 0).sum(0)
    return {"adds": int((nonzero - 1).clamp(min=0).sum()), "double_lanes": 0}


def check_fixed_base(device, lanes: int = MAX_DEGREE + 1,
                     plain_slice: int = FIXED_BASE_SLICE) -> dict:
    """The fixed-base kernel on the scalars of the KZG path's setup
    (τ^0 .. τ^(lanes-1), out of Montgomery form as the setup hands them
    over): against the per-window route it replaced on every lane, against
    its plain version on the first and the last ``plain_slice`` lanes, and
    against the host runtime's fixed base on fixed_base_crafted(), all
    exactly; the kernel and the route timed in this call, the plain version
    on the first slice, with the kernel's registers and spills.  Its
    launches here are checks, outside every path's counts."""
    import numpy as np
    import torch

    from simpleworks_tpu_torch import native
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.fields import dvec
    from simpleworks_tpu_torch.fields.bls12_377 import Fr
    from simpleworks_tpu_torch.fields.device import ints_to_limbs
    from simpleworks_tpu_torch.ops import g1_fused, srs_device
    from simpleworks_tpu_torch.utils.rng import test_rng

    g = G1Point.generator()
    tau = Fr.rand(test_rng()).value  # the KZG path's setup's first draw
    scalars = dvec.to_standard(dvec.powers_vec(tau, lanes, device))
    table = srs_device._packed_table(g, device)
    got = g1_fused.fixed_base(table, scalars)
    route = srs_device.fixed_base_per_window(g, scalars)
    sync(device)
    if not all(map(torch.equal, got, route)):
        raise AssertionError(f"the fixed-base kernel differs from the per-window route at "
                             f"{lanes} lanes")
    del route
    sync(device)
    t0 = time.perf_counter()
    first = g1_fused.fixed_base_plain(table, scalars[:, :plain_slice])
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    last = g1_fused.fixed_base_plain(table, scalars[:, -plain_slice:])
    ends = tuple(torch.cat([a[:, :plain_slice], a[:, -plain_slice:]], 1) for a in got)
    expected = tuple(torch.cat(pair, 1) for pair in zip(first, last))
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(ends, expected))
    if err:
        raise AssertionError(f"the fixed-base kernel differs from its plain version (max abs "
                             f"err {err})")
    del got, ends, expected
    crafted = fixed_base_crafted()
    host = native.g1_fixed_base_raw(g, crafted)  # [N, 18] u64 Jacobian Montgomery words
    host_planes = np.ascontiguousarray(host).view("<u2").reshape(-1, 3, 24).transpose(1, 2, 0)
    out = g1_fused.fixed_base(
        table, torch.from_numpy(ints_to_limbs(crafted, 16).astype(np.int32)).to(device))
    if not torch.equal(torch.stack(out).cpu(), torch.from_numpy(host_planes.astype(np.int32))):
        raise AssertionError("the fixed-base kernel differs from the host runtime on the "
                             "crafted scalars")
    resources = g1_fused.kernel_resources()["g1_fixed_base"] if device.type == "cuda" else {}
    return {"shape": [24, lanes], "windows": 32, **fixed_base_work(scalars), **resources,
            "equal": True, "route_equal": True, "host_scalars": len(crafted),
            "host_equal": True, "max_abs_err": err,
            "plain_shape": [24, plain_slice], "checked_lanes": f"first and last {plain_slice}",
            "plain_ms": plain_ms,
            "route_ms": time_ms(lambda: srs_device.fixed_base_per_window(g, scalars), device,
                                reps=3),
            "ms": time_ms(lambda: g1_fused.fixed_base(table, scalars), device)}


def check_accumulate(device, log_n: int = ACCUMULATE_LOG, c: int = ACCUMULATE_C,
                     max_degree: int = MAX_DEGREE, keep: list | None = None) -> dict:
    """The bucket-accumulate kernel at the widest group of the MSM path's
    2^log_n-point MSM (window bits c) over the KZG path's SRS, at the
    group's real depth: the kernel against the plain version (exact),
    timed, with its registers and spills.  Its launches here are checks,
    outside every path's counts.  ``keep`` receives the group's bucket sums
    for check_combine."""
    import torch

    from simpleworks_tpu_torch.kzg import kzg10
    from simpleworks_tpu_torch.ops import g1_fused
    from simpleworks_tpu_torch.ops import msm_pippenger as mp
    from simpleworks_tpu_torch.utils.rng import test_rng

    srs = kzg10.setup(max_degree, test_rng(), device=device)
    coeffs = random_poly(1 << log_n, 100 + log_n, device)  # run_msm's coefficients
    digits, stats = mp.mont_digits(coeffs, c)
    metas = mp._meta_from_stats(
        [(w, int(o), max(int(m), 1)) for w, (o, m) in enumerate(stats.tolist())],
        mp.target_lanes(device))
    window_ids, segs, b_g, depth = max(metas, key=lambda m: len(m[0]) * m[1] * m[2])
    ids = torch.tensor(window_ids, dtype=torch.int64, device=device)
    idx, valid = mp.device_grid_from_digits(digits.index_select(0, ids), depth, segs, b_g, 0)
    rows = srs.powers_xy.reshape(48, -1).t().contiguous()  # as accumulate_windows lays it out
    sync(device)
    t0 = time.perf_counter()
    expected = g1_fused.madd_accumulate_plain(None, rows, idx, valid)
    sync(device)
    plain_ms = (time.perf_counter() - t0) * 1e3
    got = g1_fused.madd_accumulate(None, rows, idx, valid)
    sync(device)
    err = max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
              for a, b in zip(got, expected))
    if not all(map(torch.equal, got, expected)):
        raise AssertionError(f"the accumulate kernel disagrees with its plain version "
                             f"(max abs err {err})")
    if keep is not None:
        keep.append((f"2^{log_n}, c = {c}", got, len(window_ids), segs, b_g))
    del got
    # each lane sums distinct SRS powers tau^i G, so no accumulator equals the
    # point it adds (that would be a relation among the powers): no cell doubles
    return {"shape": [24, idx.shape[1]], "depth": depth, "windows": len(window_ids),
            "segments": segs, "buckets": b_g, "valid_cells": int(valid.sum()),
            "double_cells": 0, "start": False, "equal": True, "max_abs_err": err,
            **g1_fused.kernel_resources()["g1_fused_madd"],
            "ms": time_ms(lambda: g1_fused.madd_accumulate(None, rows, idx, valid), device,
                          reps=3, inner=3),
            "plain_ms": plain_ms}


def combine_work(acc3, w_count: int, segs: int, b: int) -> dict:
    """The combine's work on this data.  What the function needs, which the
    bound counts: of the (S − 1)·b fold adds of each window those whose
    operands are both points (an identity operand needs no arithmetic), and
    the 2(b − 2) adds of the running sums R_d = R_{d+1} + S_d and T = T + R_d
    that give Σ_d d·S_d (each counted, beside an empty bucket too); of those, the fold lanes whose H = r = 0 also double
    (a running sum of the SRS's bucket sums never meets its own operand:
    that would be a relation among the powers of tau, so none doubles).
    What the kernel's step-doubling scan runs, reported beside it: every
    fold lane and every suffix lane whose operand lies inside its window,
    and those of them whose H = r = 0 run the doubling.  One run of the
    per-step route that evaluates H and r (through the field kernels)
    beside each add."""
    import torch

    from simpleworks_tpu_torch.ops import g1_fused, g1_limb

    f = g1_limb._F
    log_b = b.bit_length() - 1
    shifts = iter([None] * (segs.bit_length() - 1) + [1 << i for _ in range(2)
                                                       for i in range(log_b)])
    work = {"fold_lanes": 0, "fold_double_lanes": 0, "kernel_add_lanes": 0,
            "kernel_double_lanes": 0}

    def add(p, q):
        k = next(shifts)
        (X1, Y1, Z1), (X2, Y2, Z2) = p, q
        z1z1, z2z2 = f.mul(Z1, Z1), f.mul(Z2, Z2)
        h = f.sub(f.mul(X2, z1z1), f.mul(X1, z2z2))
        r = f.sub(f.mul(f.mul(Y2, Z1), z1z1), f.mul(f.mul(Y1, Z2), z2z2))
        lane = torch.arange(X1.shape[1], device=X1.device)
        inside = torch.ones_like(lane, dtype=torch.bool) if k is None else lane % b + k < b
        doubles = inside & (h == 0).all(0) & (r == 0).all(0)
        work["kernel_add_lanes"] += int(inside.sum())
        work["kernel_double_lanes"] += int(doubles.sum())
        if k is None:
            points = (Z1 != 0).any(0) & (Z2 != 0).any(0)
            work["fold_lanes"] += int(points.sum())
            work["fold_double_lanes"] += int((doubles & points).sum())
        return g1_fused.fused_add(p, q)

    g1_fused.bucket_combine_plain(acc3, w_count, segs, b, add=add)
    return {"add_lanes": work["fold_lanes"] + w_count * 2 * (b - 2),
            "double_lanes": work["fold_double_lanes"],
            "kernel_add_lanes": work["kernel_add_lanes"],
            "kernel_double_lanes": work["kernel_double_lanes"]}


def window_sums_host(acc3, w: int, segs: int, b: int):
    """Σ_d d·S_d of window w by the host point law, from the bucket sums
    (lane w·S·b + s·b + d of acc3)."""
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.ops import g1_limb

    lo = w * segs * b
    pts = g1_limb.points_from_limb_major(tuple(a[:, lo : lo + segs * b] for a in acc3))
    buckets = [G1Point.identity()] * b
    for i, pt in enumerate(pts):
        buckets[i % b] = buckets[i % b].add(pt)
    running, total = G1Point.identity(), G1Point.identity()
    for d in range(b - 1, 0, -1):
        running = running.add(buckets[d])
        total = total.add(running)
    return total


def check_combine(device, accumulated=(), log_n: int = COMBINE_LOG,
                  max_degree: int = MAX_DEGREE) -> list:
    """The bucket-combine kernel on every group of the MSM path's
    2^log_n-point MSM (its bucket sums from the accumulate kernel) and on
    the groups of ``accumulated`` (check_accumulate's ``keep``): equal to
    the plain version and to the per-step route (one fused-add launch a
    step, bucket_combine_plain with g1_fused.fused_add), exactly, and the
    first and last windows equal to the host point law; the three timed.
    Launches here are checks, outside every path's counts."""
    import torch

    from simpleworks_tpu_torch.kzg import kzg10
    from simpleworks_tpu_torch.ops import g1_fused, g1_limb
    from simpleworks_tpu_torch.ops import msm_pippenger as mp
    from simpleworks_tpu_torch.utils.rng import test_rng

    srs = kzg10.setup(max_degree, test_rng(), device=device)
    rows = srs.powers_xy.reshape(48, -1).t().contiguous()
    coeffs = random_poly(1 << log_n, 100 + log_n, device)  # run_msm's coefficients
    c = mp._auto_window_bits(1 << log_n)
    digits, stats = mp.mont_digits(coeffs, c)
    metas = mp._meta_from_stats(
        [(w, int(o), max(int(m), 1)) for w, (o, m) in enumerate(stats.tolist())],
        mp.target_lanes(device))
    groups = []
    for window_ids, segs, b_g, depth in metas:
        ids = torch.tensor(window_ids, dtype=torch.int64, device=device)
        idx, valid = mp.device_grid_from_digits(digits.index_select(0, ids), depth, segs, b_g, 0)
        groups.append((f"2^{log_n}, c = {c}", g1_fused.madd_accumulate(None, rows, idx, valid),
                       len(window_ids), segs, b_g))
    del rows, idx, valid
    groups += list(accumulated)
    resources = g1_fused.kernel_resources()["g1_bucket_combine"] if device.type == "cuda" else {}
    results = []
    for label, acc, w, segs, b in groups:
        got = g1_fused.bucket_combine(acc, w, segs, b)
        sync(device)
        t0 = time.perf_counter()
        expected = g1_fused.bucket_combine_plain(acc, w, segs, b)
        sync(device)
        plain_ms = (time.perf_counter() - t0) * 1e3
        route = g1_fused.bucket_combine_plain(acc, w, segs, b, add=g1_fused.fused_add)
        err = max(int((x.to(torch.int64) - y.to(torch.int64)).abs().max())
                  for x, y in zip(got, expected))
        if not (all(map(torch.equal, got, expected)) and all(map(torch.equal, got, route))):
            raise AssertionError(f"the combine kernel disagrees at {label}, W = {w}, S = {segs}, "
                                 f"b = {b} (max abs err against plain {err})")
        sums = g1_limb.points_from_limb_major(got)
        for win in sorted({0, w - 1}):
            if sums[win] != window_sums_host(acc, win, segs, b):
                raise AssertionError(f"the combine's window {win} at {label} differs from the "
                                     f"host point law")
        row = {"msm": label, "shape": [24, acc[0].shape[1]], "windows": w, "segments": segs,
               "buckets": b, **combine_work(acc, w, segs, b), **resources, "equal": True,
               "route_equal": True, "max_abs_err": err, "plain_ms": plain_ms,
               "route_ms": time_ms(lambda: g1_fused.bucket_combine_plain(
                   acc, w, segs, b, add=g1_fused.fused_add), device),
               "ms": time_ms(lambda: g1_fused.bucket_combine(acc, w, segs, b), device, inner=3,
                             queue_ahead=True)}
        results.append(row)
    return results


def check_ntt(device, log_n: int = NTT_LOG, oracle_log: int = ORACLE_LOG,
              sharded_log: int = SHARDED_NTT_LOG, shards: int = SHARDS,
              timed_logs=NTT_TIMED_LOGS) -> dict:
    """The two NTTs on the card.  The limb matmul (ops/ntt.py, the TPU's
    route, which no path runs): its reduce kernel against its plain version
    on real first-level planes (exact).  The butterfly (poly/ntt_device.py,
    the route of dvec.fft/ifft and of the sharded plane): the pass kernel
    against its plain passes and against the stage route (whose bit-reversal
    and stage kernels, which no path runs, are held against their plain
    versions, each stage on the input its plain version gets), exactly, at
    2^log_n forward and inverse and on the sharded plane's column and row
    batches of a 2^sharded_log transform, the pass kernel timed beside the
    stage route and required to be faster on the card; its fft against the
    pure-Python ntt_host at 2^oracle_log; the two NTTs equal at 2^log_n both
    ways; dvec's round trip at 2^log_n, which must launch the pass kernel
    its plan's passes a transform and no other NTT kernel; and both NTTs'
    fft and ifft timed at 2^timed_logs beside the seconds their tables
    took."""
    import torch

    from simpleworks_tpu_torch.fields import dvec
    from simpleworks_tpu_torch.fields.bls12_377 import fr_root_of_unity
    from simpleworks_tpu_torch.ops import _build, ntt
    from simpleworks_tpu_torch.ops import ntt_butterfly as bf
    from simpleworks_tpu_torch.parallel.ntt_sharded import _split
    from simpleworks_tpu_torch.poly.domain import ntt_host
    from simpleworks_tpu_torch.poly.ntt_device import get_device_ntt

    routes = {"butterfly": get_device_ntt, "limb_matmul": ntt.get_ntt}
    tables_s: dict = {}

    def transform(route, m):
        """The route's transform of m points; the seconds of its first build."""
        if (route, m) not in tables_s:
            sync(device)
            t0 = time.perf_counter()
            routes[route](m, device)
            sync(device)
            tables_s[(route, m)] = time.perf_counter() - t0
        return routes[route](m, device)

    def max_err(got, want):
        return int((got.to(torch.int64) - want.to(torch.int64)).abs().max()) if got.numel() else 0

    n = 1 << log_n
    x = random_poly(n, 7, device)
    limb = transform("limb_matmul", n)
    planes = limb.partial_planes(x)
    if int(planes.max()) >= 1 << 29 or int(planes.min()) < 0:
        raise AssertionError("partial planes outside the reduce kernel's bound")
    got, ref = ntt.ntt_reduce(planes), ntt.ntt_reduce_plain(planes)
    sync(device)
    reduce_row = {"shape": list(planes.shape), "equal": bool(torch.equal(got, ref)),
                  "max_abs_err": max_err(got, ref),
                  "ms": time_ms(lambda: ntt.ntt_reduce(planes), device, inner=20, queue_ahead=True),
                  "plain_ms": time_ms(lambda: ntt.ntt_reduce_plain(planes), device, reps=3)}
    if not reduce_row["equal"]:
        raise AssertionError(f"ntt_reduce kernel disagrees with its plain version at {list(planes.shape)}")
    del planes, got, ref

    def check_kernels_on(x3, inverse: bool):
        """The pass kernel and the stage route's two kernels on the batch x3
        [16, B, m] against their plain versions (the stage route's each
        stage on the input its plain version gets), and the pass kernel
        against the stage route -> (bit-reversal row, stages row, pass row,
        the pass kernel's transform)."""
        m = x3.shape[2]
        stages = m.bit_length() - 1
        tr = transform("butterfly", m)
        table = tr.twiddles_inv if inverse else tr.twiddles_fwd
        tables = tr.tables[inverse]
        factor = tr.n_inv if inverse else None

        def scale(s):
            return factor if s == stages - 1 else None

        def run_stages(stage_fn, z):
            for s in range(stages):
                stage_fn(z, s, table, scale(s))

        y, want = bf.ntt_bitrev(x3), bf.ntt_bitrev_plain(x3)
        sync(device)
        rev = bf.bit_reverse_indices(m, device)
        rev_row = {"shape": list(x3.shape), "inverse": inverse, "equal": bool(torch.equal(y, want)),
                   "max_abs_err": max_err(y, want),
                   "ms": time_ms(lambda: bf.ntt_bitrev(x3), device, inner=10, queue_ahead=True),
                   "plain_ms": time_ms(lambda: bf.ntt_bitrev_plain(x3), device, reps=3),
                   # one PyTorch call computes the permutation: the yardstick
                   "library_ms": time_ms(lambda: x3.index_select(2, rev), device, inner=10,
                                         queue_ahead=True)}
        equal, err = True, 0
        for s in range(stages):
            want = bf.ntt_butterfly_plain(y.clone(), s, table, scale(s))
            bf.ntt_butterfly(y, s, table, scale(s))
            sync(device)
            equal = equal and bool(torch.equal(y, want))
            err = max(err, max_err(y, want))
        scratch = y.clone()  # timed in place: the values stay below p
        fly_row = {"shape": list(x3.shape), "inverse": inverse, "stages": stages,
                   "equal": equal, "max_abs_err": err,
                   "ms": time_ms(lambda: run_stages(bf.ntt_butterfly, scratch), device, inner=3,
                                 queue_ahead=True),
                   "plain_ms": time_ms(lambda: run_stages(bf.ntt_butterfly_plain, scratch),
                                       device, reps=3)}
        del scratch
        got, want = bf.ntt_transform(x3, tables, factor), bf.ntt_passes_plain(x3, tables, factor)
        sync(device)
        plan = bf.pass_plan(stages, x3.shape[1])
        pass_row = {"shape": list(x3.shape), "inverse": inverse, "stages": stages,
                    "passes": len(plan), "plan": [list(step) for step in plan],
                    "equal": bool(torch.equal(got, want)), "max_abs_err": max_err(got, want),
                    "stage_route_equal": bool(torch.equal(got, y)),
                    "stage_route_max_abs_err": max_err(got, y),
                    "ms": time_ms(lambda: bf.ntt_transform(x3, tables, factor), device, inner=10,
                                  queue_ahead=True),
                    "plain_ms": time_ms(lambda: bf.ntt_passes_plain(x3, tables, factor), device,
                                        reps=3),
                    # the stage route in the same call: its bit reversal and stages
                    "stage_route_ms": rev_row["ms"] + fly_row["ms"], **resources}
        for name, row in (("ntt_bitrev", rev_row), ("ntt_butterfly", fly_row), ("ntt_pass", pass_row)):
            if not row["equal"]:
                raise AssertionError(f"{name} kernel disagrees with its plain version at "
                                     f"{row['shape']} (inverse={inverse})")
        if not pass_row["stage_route_equal"]:
            raise AssertionError(f"the pass kernel and the stage route differ at {pass_row['shape']} "
                                 f"(inverse={inverse})")
        if device.type == "cuda" and pass_row["ms"] >= pass_row["stage_route_ms"]:
            raise AssertionError(f"the pass kernel is not faster than the stage route at "
                                 f"{pass_row['shape']}: {pass_row['ms']} ms against "
                                 f"{pass_row['stage_route_ms']} ms")
        return rev_row, fly_row, pass_row, got

    resources = bf.kernel_resources() if device.type == "cuda" else {}
    # the sharded plane's batches: columns [16, n2/shards, n1], rows
    # [16, n1/shards, n2]; then 2^log_n, the forward transform last (the
    # kernels line's row)
    n1, n2 = _split(1 << sharded_log)
    batches = [(n2 // shards, n1), (n1 // shards, n2)]
    bitrev_rows, butterfly_rows, pass_rows = [], [], []
    for k, (b, m) in enumerate(batches):
        xb = random_poly(b * m, 20 + k, device).reshape(16, b, m)
        for inverse in (False, True):
            rev_row, fly_row, pass_row, _ = check_kernels_on(xb, inverse)
            bitrev_rows.append(rev_row)
            butterfly_rows.append(fly_row)
            pass_rows.append(pass_row)
    transformed = {}
    for inverse in (True, False):
        rev_row, fly_row, pass_row, transformed[inverse] = check_kernels_on(x[:, None, :], inverse)
        bitrev_rows.append(rev_row)
        butterfly_rows.append(fly_row)
        pass_rows.append(pass_row)

    # the two NTTs agree; dvec's transforms run the pass kernel alone
    fly = transform("butterfly", n)
    for inverse, run_fly, run_limb in ((False, fly.fft_mont, limb.fft_mont),
                                       (True, fly.ifft_mont, limb.ifft_mont)):
        got = run_fly(x)
        if not (torch.equal(got, transformed[inverse][:, 0, :]) and torch.equal(got, run_limb(x))):
            raise AssertionError(f"the butterfly and the limb matmul differ at 2^{log_n} "
                                 f"(inverse={inverse})")
    del transformed
    before = dict(_build.LAUNCHES)
    y = dvec.fft(x, n)
    back = dvec.ifft(y, n)
    sync(device)
    dvec_launches = {k: _build.LAUNCHES[k] - before[k]
                     for k in ("ntt_pass", "ntt_bitrev", "ntt_butterfly", "ntt_reduce")}
    on_card = device.type == "cuda"  # a CPU tensor's plain route launches nothing
    passes = len(bf.pass_plan(log_n, 1))
    if dvec_launches != {"ntt_pass": 2 * passes * on_card, "ntt_bitrev": 0, "ntt_butterfly": 0,
                         "ntt_reduce": 0}:
        raise AssertionError(f"dvec's transforms did not run the pass kernel alone, "
                             f"{passes} launches a transform: {dvec_launches}")
    if not torch.equal(back, x):
        raise AssertionError(f"ifft(fft(x)) != x at 2^{log_n}")
    del y, back

    m = 1 << oracle_log
    xs = random_poly(m, 8, device)
    oracle = transform("butterfly", m)
    evals = oracle.fft_mont(xs)
    if dvec.to_ints(evals) != ntt_host(dvec.to_ints(xs), fr_root_of_unity(m)):
        raise AssertionError(f"the butterfly's fft differs from ntt_host at 2^{oracle_log}")
    if not torch.equal(oracle.ifft_mont(evals), xs):
        raise AssertionError(f"the butterfly's ifft(fft(x)) != x at 2^{oracle_log}")

    timings = []
    for log_t in timed_logs:
        xt = random_poly(1 << log_t, 9, device)
        row = {"log_n": log_t}
        for route in routes:
            tr = transform(route, 1 << log_t)
            yt = tr.fft_mont(xt)
            row[route] = {"tables_s": tables_s[(route, 1 << log_t)],
                          "fft_ms": time_ms(lambda: tr.fft_mont(xt), device, reps=3),
                          "ifft_ms": time_ms(lambda: tr.ifft_mont(yt), device, reps=3)}
        timings.append(row)
    ntt.get_ntt.cache_clear()  # no path runs the limb matmul: free its tables
    return {"reduce": reduce_row, "bitrev": bitrev_rows, "butterfly": butterfly_rows,
            "pass": pass_rows, "pass_kernel_resources": resources,
            "sharded_batches": [[16, b, m] for b, m in batches], "limb_matmul_equal": True,
            "roundtrip_log_n": log_n, "dvec_launches": dvec_launches,
            "oracle_log_n": oracle_log, "oracle_equal": True, "timings": timings}


def square_add_chain(steps: int, x: int = PUBLIC_INPUT):
    """Public input x, witness x_0 = x, and the constraints (x - x_0)·1 = 0
    and x_i·x_i = x_{i+1} - x_i: a chain of raw R1CS variables (the pattern
    of the reference's prover tests) whose C rows hold two terms."""
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
    from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
    from simpleworks_tpu_torch.r1cs.constraint_system import ONE, ConstraintSystem

    cs = ConstraintSystem(ConstraintF)
    a = cs.new_input_variable(x)
    cur_val = x
    cur = cs.new_witness_variable(cur_val)
    cs.enforce_constraint(cs.lc((1, a)) - cs.lc((1, cur)), cs.lc((1, ONE)), cs.lc())
    for _ in range(steps):
        nxt_val = (cur_val * cur_val + cur_val) % P
        nxt = cs.new_witness_variable(nxt_val)
        cs.enforce_constraint(cs.lc((1, cur)), cs.lc((1, cur)), cs.lc((1, nxt)) - cs.lc((1, cur)))
        cur, cur_val = nxt, nxt_val
    return cs


def schnorr_circuit(message: bytes = MESSAGE):
    """The circuit of the bench prove, on its draw sequence: test_rng(),
    setup, keygen, sign, then the schnorr-verify circuit's synthesis."""
    from simpleworks_tpu_torch.examples.schnorr_circuit import synthesize
    from simpleworks_tpu_torch.schnorr import schnorr
    from simpleworks_tpu_torch.utils.rng import test_rng

    rng = test_rng()
    params = schnorr.setup(rng)
    pk, sk = schnorr.keygen(params, rng)
    return synthesize(params, pk, message, schnorr.sign(params, sk, message, rng))


def run_marlin(device, build=schnorr_circuit, public=(), sizes=SRS_SIZES, reference=None,
               keep: dict | None = None) -> dict:
    """synthesis (``build()``) -> universal_setup -> index -> prove (twice) ->
    verify through the port's public functions; returns the seconds of each
    step and what the checks saw.  Raises on a wrong result: verify must
    accept the proof and reject it with one evaluation changed, and with the
    public input changed where the circuit has one; with ``reference`` (the
    fixture's dict), the verifying key and the proof must equal its bytes.
    ``keep`` receives the proving key, the circuit and the proof bytes."""
    import dataclasses

    import torch

    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS
    from simpleworks_tpu_torch.marlin import ahp
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof, serialize_verifying_key
    from simpleworks_tpu_torch.ops._build import LAUNCHES
    from simpleworks_tpu_torch.utils.observability import PROVER_TIMER

    steps_s: dict[str, float] = {}
    public = list(public)
    cs = timed_step(device, steps_s, "synthesis_s", build)
    srs = timed_step(device, steps_s, "setup_s", lambda: marlin.universal_setup(
        *sizes, marlin.generate_rand(), device=device))
    PROVER_TIMER.reset()
    PROVER_TIMER.synchronize = True
    pk, vk = timed_step(device, steps_s, "index_s", lambda: marlin.index(srs, cs))
    index_regions = dict(PROVER_TIMER.totals)
    info = vk.info
    expected = ahp.max_degree_for(*sizes)
    if srs.max_degree != expected:
        raise AssertionError(f"SRS degree {srs.max_degree} != {expected}")
    shape = {"n": info.domain_h_size, "m": info.domain_k_size, "ell": info.num_instance_padded,
             "constraints": info.num_constraints, "non_zero": info.num_non_zero}
    proof_cold = timed_step(device, steps_s, "prove_cold_s", lambda: marlin.prove(pk, cs))
    PROVER_TIMER.reset()
    before = dict(LAUNCHES)
    proof = timed_step(device, steps_s, "prove_warm_s", lambda: marlin.prove(pk, cs))
    warm_launches = {k: v - before[k] for k, v in LAUNCHES.items()}
    regions = dict(PROVER_TIMER.totals)
    PROVER_TIMER.synchronize = False
    proof_bytes = serialize_proof(proof)
    if proof_bytes != serialize_proof(proof_cold):
        raise AssertionError("the two proves of one circuit differ")
    same = None if reference is None else check_reference(
        reference, serialize_verifying_key(vk), proof_bytes)
    if keep is not None:
        keep.update(pk=pk, cs=cs, proof=proof_bytes)
    accepted = timed_step(device, steps_s, "verify_s", lambda: marlin.verify(vk, public, proof))
    bad_evals = dict(proof.evaluations)
    bad_evals["w"] = (bad_evals["w"] + 1) % FR_MODULUS
    tampered = dataclasses.replace(proof, evaluations=bad_evals)
    rejected_eval = not marlin.verify(vk, public, tampered)
    rejected_input = not public or not marlin.verify(vk, [public[0] + 1, *public[1:]], proof)
    if not (accepted and rejected_eval and rejected_input):
        raise AssertionError(f"verify: accepted={accepted}, rejected tampered evaluation="
                             f"{rejected_eval}, rejected changed input={rejected_input}")
    return {"shape": shape, "srs_max_degree": srs.max_degree, "steps": steps_s,
            "index_regions": index_regions, "prove_warm_regions": regions,
            "prove_warm_launches": warm_launches,
            "proof_bytes": len(proof_bytes), "reference": same, "verify": accepted,
            "verify_tampered_evaluation": not rejected_eval,
            "verify_changed_input": None if not public else not rejected_input}


def check_reference(reference: dict, vk_bytes: bytes, proof_bytes: bytes) -> dict:
    """The verifying key, then the proof, against the reference's bytes;
    on a difference prints the first differing byte offset and raises."""
    out = {}
    for key, got in (("verifying_key", vk_bytes), ("proof", proof_bytes)):
        want = bytes.fromhex(reference[key]["hex"])
        if got != want:
            at = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                      min(len(got), len(want)))
            emit({"reference_mismatch": {"what": key, "first_differing_byte": at,
                                         "bytes": len(got), "reference_bytes": len(want)}})
            raise AssertionError(f"the card's {key} differs from the reference's at byte {at}")
        out[key] = {"bytes": len(got), "sha256": hashlib.sha256(got).hexdigest(), "equal": True}
    return out


def run_affine_prove(device, pk, cs, proof_bytes: bytes) -> dict:
    """One more warm prove with the MSM accumulate forced to "affine" (the
    batch-affine add with a Fermat pow a row): its proof bytes must equal
    the madd prove's; returns its seconds and regions."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof
    from simpleworks_tpu_torch.ops import msm_pippenger
    from simpleworks_tpu_torch.utils.observability import PROVER_TIMER

    default = msm_pippenger.default_accum
    msm_pippenger.default_accum = lambda device: "affine"
    PROVER_TIMER.reset()
    PROVER_TIMER.synchronize = True
    try:
        sync(device)
        t0 = time.perf_counter()
        proof = marlin.prove(pk, cs)
        sync(device)
        seconds = time.perf_counter() - t0
    finally:
        msm_pippenger.default_accum = default
        PROVER_TIMER.synchronize = False
    if serialize_proof(proof) != proof_bytes:
        raise AssertionError("the affine-accumulate prove's bytes differ from the madd prove's")
    return {"prove_warm_s": seconds, "prove_warm_regions": dict(PROVER_TIMER.totals),
            "equal_bytes": True}


@contextlib.contextmanager
def pow_launches_by_caller(counts: dict):
    """While the block runs, counts into ``counts`` the Fermat pow's launches
    made inside dvec.inv, g1_limb.normalize_affine and g1_limb.affine_madd
    (the affine accumulate's row)."""
    from simpleworks_tpu_torch.fields import dvec
    from simpleworks_tpu_torch.ops import _build, g1_limb

    targets = {"dvec.inv": (dvec, "inv"),
               "g1_limb.normalize_affine": (g1_limb, "normalize_affine"),
               "g1_limb.affine_madd": (g1_limb, "affine_madd")}
    saved = {key: getattr(mod, attr) for key, (mod, attr) in targets.items()}

    def counting(key, fn):
        def wrapper(*args, **kwargs):
            before = _build.LAUNCHES["mont_pow"]
            try:
                return fn(*args, **kwargs)
            finally:
                counts[key] += _build.LAUNCHES["mont_pow"] - before
        return wrapper

    for key, (mod, attr) in targets.items():
        counts[key] = 0
        setattr(mod, attr, counting(key, saved[key]))
    try:
        yield counts
    finally:
        for key, (mod, attr) in targets.items():
            setattr(mod, attr, saved[key])


def run_chain(device, steps: int = CHAIN_STEPS, sizes=CHAIN_SRS_SIZES) -> dict:
    """The Marlin path on a square-add chain with one public input."""
    return run_marlin(device, lambda: square_add_chain(steps), [PUBLIC_INPUT], sizes)


def run_msm(device, logs=MSM_LOGS, max_degree: int = MAX_DEGREE) -> dict:
    """msm_device_mont over the KZG path's SRS (its memo) on seed-made
    coefficients of 2^log points, under the batch-affine accumulate and the
    fused mixed add: equal group elements, and the seconds of each."""
    from simpleworks_tpu_torch.kzg import kzg10
    from simpleworks_tpu_torch.ops.msm_pippenger import msm_device_mont
    from simpleworks_tpu_torch.utils.rng import test_rng

    srs = kzg10.setup(max_degree, test_rng(), device=device)
    out = {}
    for log in logs:
        coeffs = random_poly(1 << log, 100 + log, device)
        results, seconds = {}, {}
        for accum in ("affine", "madd"):
            msm_device_mont(srs.powers_xy, coeffs, accum=accum)  # warm: allocator, caches
            sync(device)
            t0 = time.perf_counter()
            results[accum] = msm_device_mont(srs.powers_xy, coeffs, accum=accum)
            sync(device)
            seconds[accum] = time.perf_counter() - t0
        if results["affine"] != results["madd"]:
            raise AssertionError(f"the affine and madd MSMs differ at 2^{log}")
        out[f"2^{log}"] = {"affine_s": seconds["affine"], "madd_s": seconds["madd"],
                           "equal": True}
    return out


def run_pin(device, steps: int = PIN_STEPS, sizes=PIN_SRS_SIZES) -> dict:
    """One small circuit proved on the card (shown there by its launches)
    and on the CPU: equal bytes."""
    import torch

    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof
    from simpleworks_tpu_torch.ops import _build

    out = {}
    for dev in (device, torch.device("cpu")):
        _build.reset_launches()
        cs = square_add_chain(steps)
        srs = marlin.universal_setup(*sizes, marlin.generate_rand(), device=dev)
        pk, vk = marlin.index(srs, cs)
        if pk.device != dev:
            raise AssertionError(f"the pin's key lives on {pk.device}, not {dev}")
        proof = marlin.prove(pk, cs)
        if not marlin.verify(vk, [PUBLIC_INPUT], proof):
            raise AssertionError(f"the pin's proof on {dev} does not verify")
        out[dev.type] = serialize_proof(proof)
        if dev.type == "cuda":
            launches = dict(_build.LAUNCHES)
    if out["cuda"] != out["cpu"]:
        raise AssertionError("proof bytes differ between the card and the CPU")
    if not all(launches[k] for k in ("mont_mul", "ntt_pass", "g1_fused_madd")):
        raise AssertionError(f"the pin's card side did not run on the card: {launches}")
    return {"steps": steps, "srs_sizes": list(sizes), "proof_bytes": len(out["cuda"]),
            "equal_bytes": True, "card_launches": launches}


@contextlib.contextmanager
def calls_timed(device, targets: dict):
    """While the block runs, each function ``targets[key] = (module,
    attribute)`` appends ``(seconds, result)`` of each of its calls to the
    yielded ``calls[key]``, the device synchronised around the call (a
    result that is not a bool is kept as None)."""
    saved = {key: getattr(mod, attr) for key, (mod, attr) in targets.items()}
    calls: dict[str, list] = {key: [] for key in targets}

    def timing(key, fn):
        def wrapper(*args, **kwargs):
            sync(device)
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            sync(device)
            calls[key].append((time.perf_counter() - t0, out if isinstance(out, bool) else None))
            return out
        return wrapper

    for key, (mod, attr) in targets.items():
        setattr(mod, attr, timing(key, saved[key]))
    try:
        yield calls
    finally:
        for key, (mod, attr) in targets.items():
            setattr(mod, attr, saved[key])


def run_merkle(device, reference=None, leaves=None, **tree_kwargs) -> dict:
    """The merkle-tree workload, through the demo CLI's sequence
    (examples/run.py ``merkle_tree_sequence``, which raises on a wrong
    membership check or verdict), each step timed; then a second (warm)
    prove whose bytes must equal the first's, since each prove draws a fresh
    test_rng().  The build is split into its one ``universal_setup``, its
    one ``index`` and the rest (Pedersen parameters, both trees, the blank
    tree's circuit).  With ``reference`` (the fixture's ``merkle``), the
    root, the verifying key and the proof must equal its.  ``tree_kwargs``
    go to SimpleMerkleTree (the reference's parameters when empty).  Raises
    on a wrong result."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.examples.merkle_tree import EXAMPLE_LEAVES
    from simpleworks_tpu_torch.examples.run import merkle_tree_sequence
    from simpleworks_tpu_torch.marlin.serialization import serialize_verifying_key
    from simpleworks_tpu_torch.utils.observability import PROVER_TIMER

    leaves = EXAMPLE_LEAVES if leaves is None else leaves
    steps: dict[str, float] = {}
    targets = {key: (marlin, key) for key in ("universal_setup", "index", "prove")}
    with calls_timed(device, targets) as calls:
        out = merkle_tree_sequence(lambda key, _label, fn: timed_step(device, steps, f"{key}_s", fn),
                                   leaves, device=device, **tree_kwargs)
        tree, cold = out["tree"], out["proof"]
        PROVER_TIMER.reset()
        PROVER_TIMER.synchronize = True
        warm = timed_step(device, steps, "prove_warm_s", lambda: tree.prove(leaves[0], out["path"]))
        regions = dict(PROVER_TIMER.totals)
        PROVER_TIMER.synchronize = False
    counts = {key: len(rows) for key, rows in calls.items()}
    if counts != {"universal_setup": 1, "index": 1, "prove": 2}:
        raise AssertionError(f"the merkle path's Marlin calls {counts}: the build's split "
                             "and the proves' times would be wrong")
    (steps["setup_s"], _), = calls["universal_setup"]
    (steps["index_s"], _), = calls["index"]
    steps["tree_s"] = steps["build_s"] - steps["setup_s"] - steps["index_s"]
    # each prove step synthesises the circuit, then runs marlin.prove
    steps["marlin_prove_s"], steps["marlin_prove_warm_s"] = (t for t, _ in calls["prove"])
    if cold != warm:
        raise AssertionError("the merkle path's cold and warm proofs differ")
    root = hex(tree.tree.root())
    same = None
    if reference is not None:
        if root != reference["root"]:
            raise AssertionError(f"the tree's root {root} differs from the reference's")
        same = check_reference(reference, serialize_verifying_key(tree.verifying_key), warm)
    info = tree.verifying_key.info
    return {"leaves": list(leaves), "root": root,
            "shape": {"n": info.domain_h_size, "m": info.domain_k_size,
                      "ell": info.num_instance_padded, "constraints": info.num_constraints,
                      "non_zero": info.num_non_zero},
            "srs_max_degree": tree.proving_key.srs.max_degree, "steps": steps,
            "prove_warm_regions": regions, "proof_bytes": len(warm), "reference": same}


def run_payments(device, reference=None, prove_transactions: bool = True) -> dict:
    """The simple-payments workload, through the demo CLI's sequence
    (examples/run.py ``simple_payments_sequence``, which raises on a wrong
    verdict or balance), each step timed.  With ``prove_transactions`` the
    validates of the steps PAYMENTS_PIPELINES names run the per-transaction
    Marlin pipeline (setup, index, prove, verify of the schnorr circuit) on
    ``device`` (the sequence's ``Parameters.prove_transactions`` set before
    each step; the verdicts, balances and roots do not depend on it): two
    pipelines, each verify True (the proofs' bytes are not held to a fixture
    here; the Marlin path holds that circuit's).  With
    ``reference`` (the fixture's ``payments``), the verdicts, balances and
    roots must equal its.  Raises on a wrong result."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.examples.run import simple_payments_sequence

    steps: dict[str, float] = {}
    pipelines: dict[str, int] = {}
    held: dict = {}  # the sequence's Parameters, once sampled
    targets = {key: (marlin, key) for key in ("universal_setup", "index", "prove", "verify")}
    with calls_timed(device, targets) as calls:

        def step(key, _label, fn):
            if "pp" in held:
                held["pp"].prove_transactions = prove_transactions and bool(PAYMENTS_PIPELINES[key])
            before = len(calls["universal_setup"])
            out = timed_step(device, steps, f"{key}_s", fn)
            pipelines[key] = len(calls["universal_setup"]) - before
            if key == "sample":
                held["pp"] = out
            return out

        out = simple_payments_sequence(step, prove_transactions, device=device)
    expected = PAYMENTS_PIPELINES if prove_transactions else dict.fromkeys(PAYMENTS_PIPELINES, 0)
    marlin_verdicts = [ok for _, ok in calls["verify"]]
    if pipelines != expected or marlin_verdicts != [True] * sum(expected.values()):
        raise AssertionError(f"the payments path ran Marlin pipelines {pipelines} "
                             f"(expected {expected}) with verdicts {marlin_verdicts}")
    if reference is not None:
        for key in ("verdicts", "balances", "roots"):
            if out[key] != reference[key]:
                raise AssertionError(f"the payments path's {key} {out[key]} differ from the "
                                     f"reference's {reference[key]}")
    return {"accounts": 32, "prove_transactions": prove_transactions, **out,
            "pipelines": pipelines, "marlin_verify": marlin_verdicts, "steps": steps,
            "pipeline_s": {key: [t for t, _ in rows] for key, rows in calls.items()},
            "reference_equal": None if reference is None else True}


def make_block(device):
    """The block path's ledger and block, from test_rng(): Parameters.sample
    (the reference's Pedersen windows and SRS scale), BLOCK_REGISTERED
    accounts holding BLOCK_BALANCE each, and the seven transactions of
    BLOCK_VERDICTS."""
    from simpleworks_tpu_torch.examples.simple_payments.account import AccountId
    from simpleworks_tpu_torch.examples.simple_payments.ledger import Parameters, State
    from simpleworks_tpu_torch.examples.simple_payments.transaction import Transaction
    from simpleworks_tpu_torch.utils.rng import test_rng

    rng = test_rng()
    pp = Parameters.sample(rng, prove_transactions=True, device=device)
    state = State(BLOCK_ACCOUNTS, pp)
    accounts = []
    for _ in range(BLOCK_REGISTERED):
        acc_id, _pk, sk = state.sample_keys_and_register(pp, rng)
        state.update_balance(acc_id, BLOCK_BALANCE)
        accounts.append((acc_id, sk))
    (a1, k1), (a2, k2), (a3, k3), (a4, k4), (a5, _k5) = accounts
    transfers = [(a1, a2, 5, k1), (a2, a3, 5, k2), (a3, a4, 5, k3), (a4, a5, 5, k4),
                 (a5, a1, 5, k1),                                  # signed with account 1's key
                 (a1, a2, BLOCK_BALANCE + 1, k1),                  # an overspend
                 (a2, AccountId(BLOCK_ACCOUNTS - 2), 5, k2)]       # an unregistered recipient
    block = [Transaction.create(pp, frm, to, amount, sk, rng) for frm, to, amount, sk in transfers]
    return pp, state, block


def run_block(device) -> dict:
    """State.validate_block(prove=True) on the block path's block: the host
    checks and the schnorr circuit's synthesis for each transaction, one
    satisfiability batch on the card, one SRS, and the pipelined index and
    prove of the four valid transactions.  Checks the verdicts, that each of
    the four proofs passed marlin.verify, and that the first and the last
    equal, byte for byte, a serial marlin.prove of the same circuit with the
    same rng; returns the seconds of each stage and the pipeline's stats.
    Raises on a wrong result."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof
    from simpleworks_tpu_torch.parallel import proof_pipeline, witness_dp
    from simpleworks_tpu_torch.utils.rng import test_rng

    pp, state, block = make_block(device)
    seen: dict = {}
    stream, check = proof_pipeline.prove_indexed_stream, witness_dp.sharded_check_host

    def checking(*args, **kwargs):
        seen["host_s"] = time.perf_counter() - t0  # the host checks and the syntheses
        return check(*args, **kwargs)

    def streaming(srs, circuits, **kwargs):
        seen.update(srs=srs, circuits=list(circuits))
        results, seen["stats"] = stream(srs, seen["circuits"], with_stats=True, **kwargs)
        return results

    targets = {"universal_setup": (marlin, "universal_setup"), "verify": (marlin, "verify"),
               "sharded_check_host": (witness_dp, "sharded_check_host")}
    proof_pipeline.prove_indexed_stream, witness_dp.sharded_check_host = streaming, checking
    try:
        with calls_timed(device, targets) as calls:
            sync(device)
            t0 = time.perf_counter()
            verdicts, proofs = state.validate_block(pp, block, prove=True, rng=test_rng())
            sync(device)
            block_s = time.perf_counter() - t0
    finally:
        proof_pipeline.prove_indexed_stream, witness_dp.sharded_check_host = stream, check
    if verdicts != BLOCK_VERDICTS:
        raise AssertionError(f"the block's verdicts {verdicts}, expected {BLOCK_VERDICTS}")
    marlin_verdicts = [ok for _, ok in calls["verify"]]
    valid = BLOCK_VERDICTS.count(True)
    if marlin_verdicts != [True] * valid or [p is not None for p in proofs] != BLOCK_VERDICTS:
        raise AssertionError(f"the block's proofs: verify {marlin_verdicts}, "
                             f"{sum(p is not None for p in proofs)} proofs")
    serial_s = []
    for k in (0, valid - 1):  # the first and the last proof, proved again serially
        cs = seen["circuits"][k]
        pk, _ = marlin.index(seen["srs"], cs)
        sync(device)
        t1 = time.perf_counter()
        serial = serialize_proof(marlin.prove(pk, cs, test_rng()))
        sync(device)
        serial_s.append(time.perf_counter() - t1)
        if serial != proofs[k]:
            raise AssertionError(f"the block's proof {k} differs from its serial prove")
    stats = seen["stats"]
    info = marlin.index(seen["srs"], seen["circuits"][0])[1].info
    (setup_s, _), = calls["universal_setup"]
    (batch_s, _), = calls["sharded_check_host"]
    return {"transactions": len(block), "verdicts": verdicts, "marlin_verify": marlin_verdicts,
            "proof_bytes": [len(p) for p in proofs if p is not None],
            "serial_equal": [0, valid - 1],
            "shape": {"n": info.domain_h_size, "m": info.domain_k_size,
                      "constraints": info.num_constraints, "non_zero": info.num_non_zero},
            "srs_max_degree": seen["srs"].max_degree,
            "steps": {"block_s": block_s, "host_checks_and_synthesis_s": seen["host_s"],
                      "r1cs_batch_s": batch_s, "setup_s": setup_s,
                      "pipeline_wall_s": stats.wall_seconds,
                      "index_stage_busy_s": stats.stage_wall["index"],
                      "prove_stage_busy_s": stats.stage_wall["prove"],
                      "overlap_s": stats.overlap_seconds, "speedup": stats.speedup,
                      "serial_prove_s": serial_s}}


def run_pipeline(device, full: bool = True) -> dict:
    """The demo CLI's proof-pipeline sequence (examples/run.py
    ``proof_pipeline_sequence``, which raises unless every proof verifies),
    each step timed, with the pipeline's stats."""
    from simpleworks_tpu_torch.examples.run import PIPELINE_VALUES, proof_pipeline_sequence

    steps: dict[str, float] = {}
    values = PIPELINE_VALUES[full]
    out = proof_pipeline_sequence(lambda key, _label, fn: timed_step(device, steps, f"{key}_s", fn),
                                  values, device=device)
    stats = out["stats"]
    if stats.items != len(values):
        raise AssertionError(f"the pipeline proved {stats.items} of {len(values)} circuits")
    return {"proofs": len(out["proofs"]), "verified": len(values), "steps": steps,
            "stats": {"wall_s": stats.wall_seconds, "synth_busy_s": stats.synth_busy_seconds,
                      "prove_busy_s": stats.prove_busy_seconds,
                      "overlap_s": stats.overlap_seconds, "speedup": stats.speedup}}


def run_sharded(device, steps: int = CHAIN_STEPS, sizes=CHAIN_SRS_SIZES, shards: int = SHARDS,
                thresholds=None, keep: dict | None = None) -> dict:
    """The chain path's circuit proved unsharded, then with the prover's
    transforms and commits routed over ``[device] * shards``
    (ops.accel.set_prover_devices): equal bytes, and the sharded NTT and MSM
    each called.  ``thresholds`` (NTT, MSM) replace accel's for the call
    (small circuits on the CPU).  On one card this is a check of the
    routing, not a speed figure."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof
    from simpleworks_tpu_torch.ops import accel
    from simpleworks_tpu_torch.parallel import msm_sharded, ntt_sharded

    cs = square_add_chain(steps)
    srs = marlin.universal_setup(*sizes, marlin.generate_rand(), device=device)
    pk, vk = marlin.index(srs, cs)
    seconds = {}
    proofs = {}
    targets = {"ntt": (ntt_sharded, "sharded_transform"), "msm": (msm_sharded, "sharded_msm")}
    saved = (accel.SHARDED_NTT_THRESHOLD, accel.SHARDED_MSM_THRESHOLD)
    with calls_timed(device, targets) as calls:
        proofs["unsharded"] = timed_step(device, seconds, "prove_s",
                                         lambda: marlin.prove(pk, cs))
        unsharded_calls = {key: len(rows) for key, rows in calls.items()}
        if thresholds is not None:
            accel.SHARDED_NTT_THRESHOLD, accel.SHARDED_MSM_THRESHOLD = thresholds
        accel.set_prover_devices([device] * shards)
        try:
            proofs["sharded"] = timed_step(device, seconds, "prove_sharded_s",
                                           lambda: marlin.prove(pk, cs))
        finally:
            accel.set_prover_devices(None)
            accel.SHARDED_NTT_THRESHOLD, accel.SHARDED_MSM_THRESHOLD = saved
    counts = {key: len(rows) for key, rows in calls.items()}
    if any(unsharded_calls.values()) or not all(counts.values()):
        raise AssertionError(f"sharded routes called {unsharded_calls} unsharded and {counts} "
                             "sharded: the check would be vacuous")
    unsharded, sharded = (serialize_proof(proofs[k]) for k in ("unsharded", "sharded"))
    if sharded != unsharded:
        raise AssertionError("the sharded prove's bytes differ from the unsharded prove's")
    if not marlin.verify(vk, [PUBLIC_INPUT], proofs["sharded"]):
        raise AssertionError("the sharded prove's proof does not verify")
    if keep is not None:
        keep["proof_bytes"] = unsharded
    return {"shards": shards, "n": vk.info.domain_h_size, "m": vk.info.domain_k_size,
            "thresholds": list(thresholds or saved), "sharded_calls": counts,
            "sharded_s": {key: sum(t for t, _ in rows) for key, rows in calls.items()},
            "equal_bytes": True, "verify": True, "steps": seconds}


def profile_prove(device, sizes=SRS_SIZES, top: int = 15) -> dict:
    """One warm prove of the Marlin path under torch.profiler: the device's
    busy time (the sum of its kernel, copy and fill intervals, which one
    stream runs one at a time) against the prove's wall time, the busiest
    device names, the host's kernel-launch calls, and the NTT kernels'
    launches and card time."""
    from collections import defaultdict

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from simpleworks_tpu_torch import marlin

    cs = schnorr_circuit()
    srs = marlin.universal_setup(*sizes, marlin.generate_rand(), device=device)
    pk, _ = marlin.index(srs, cs)
    marlin.prove(pk, cs)  # cold: the transform tables are built here
    sync(device)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        marlin.prove(pk, cs)
        sync(device)
        wall_s = time.perf_counter() - t0
    busy_us: dict[str, float] = defaultdict(float)
    count: dict[str, int] = defaultdict(int)
    launches = 0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy_us[e.name] += e.time_range.elapsed_us()
            count[e.name] += 1
        elif e.name in ("cudaLaunchKernel", "cudaLaunchKernelExC", "cudaLaunchCooperativeKernel"):
            launches += 1
    busy_s = sum(busy_us.values()) / 1e6
    if busy_s <= 0:
        raise AssertionError("the profiler saw no device time in the prove")
    ranked = sorted(busy_us, key=busy_us.get, reverse=True)[:top]
    # the NTT's kernels: the pass kernel, and the stage route's (none expected)
    ntt = {}
    for kernel in ("ntt_pass_kernel", "ntt_butterfly_kernel", "ntt_bitrev_kernel"):
        names = [k for k in busy_us if kernel in k]
        ntt[kernel] = {"launches": sum(count[k] for k in names),
                       "s": sum(busy_us[k] for k in names) / 1e6}
    return {"wall_s": wall_s, "device_busy_s": busy_s, "busy_share": busy_s / wall_s,
            "host_launch_calls": launches, "ntt": ntt,
            "ntt_launches": sum(v["launches"] for v in ntt.values()),
            "ntt_card_s": sum(v["s"] for v in ntt.values()),
            "top": [{"name": k[:80], "s": busy_us[k] / 1e6, "count": count[k]} for k in ranked]}


def product_ops(words: int, multiplies: int, squarings: int) -> int:
    """32-bit multiply-adds of Montgomery products of ``words``-word values:
    2 N^2 a multiply (N^2 for a·b, N^2 for m·p) and N(N+1)/2 + N^2 a
    squaring (each cross product a_i a_j once), N = ``words``."""
    square = words * (words + 1) // 2 + words * words
    return multiplies * 2 * words * words + squarings * square


def g1_ops(name: str, lanes: int, double_lanes: int = 0) -> int:
    """The 32-bit multiply-adds of the Fq products of ``lanes`` point adds of
    kernel ``name`` (G1_PRODUCTS), ``double_lanes`` of them doubling too."""
    return (lanes * product_ops(12, *G1_PRODUCTS[name])
            + double_lanes * product_ops(12, *DOUBLE_PRODUCTS))


def pow_work(exponent: int, words: int) -> dict:
    """The Montgomery products one lane of the pow kernel runs for
    ``exponent`` along its schedule (ops/mont_mul.py pow_schedule at
    POW_WINDOW): x^2 and the table's multiplies, then the window's
    squarings and multiplies.  ``ops`` counts a squaring at N(N+1)/2 + N^2
    32-bit multiply-adds and a multiply at 2 N^2 (N = ``words``)."""
    from simpleworks_tpu_torch.ops import mont_mul as mm

    schedule = mm.pow_schedule(exponent, mm.POW_WINDOW)
    table = mm.pow_table_size(schedule)
    squarings = (table > 1) + (schedule[0][1] if schedule else 0)
    multiplies = table - 1 + max(len(schedule) - 1, 0)
    return {"squarings": squarings, "multiplies": multiplies,
            "ops": product_ops(words, multiplies, squarings)}


def bound_ms(name: str, shape, clock_mhz: float, exponent: int | None = None,
             double_lanes: int = 0) -> tuple[float, str]:
    """The least time the card could take for one call at ``shape``: the
    larger of the bytes moved (each input read once, each output written
    once) over the memory rate and the 32-bit multiply-adds over
    SMS x IMAD_PER_SM_CLOCK x the SM clock.  A 32 x 32 -> 64-bit product
    counts as one multiply-add; a point add counts its Fq products (g1_ops:
    the doubling on ``double_lanes`` lanes only), not its adds and selects;
    the pow counts the products of its schedule (pow_work)."""
    rows, lanes = shape
    imad_per_s = SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6
    if name in G1_PRODUCTS:
        planes = 9 if name == "g1_fused_add" else 8  # 6 or 5 in, 3 out
        nbytes = planes * rows * 4 * lanes
        ops = g1_ops(name, lanes, double_lanes)
    elif name == "ntt_reduce":
        nbytes = (rows + 16) * 4 * lanes
        ops = lanes * (17 * 16 + 17)  # 17 REDC rounds of 16 limb products, plus m
    else:
        words = rows // 2  # 32-bit words of the field
        mul_ops = 2 * words * words  # CIOS: N^2 products for a·b, N^2 for m·p
        if name == "mont_pow":
            nbytes = 2 * rows * 4 * lanes
            ops = lanes * pow_work(exponent, words)["ops"]
        else:
            nbytes = 3 * rows * 4 * lanes
            ops = lanes * (mul_ops if name == "mont_mul" else 2 * words)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / imad_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def butterfly_bound_ms(name: str, row: dict, clock_mhz: float) -> tuple[float, str]:
    """The least time the card could take for the butterfly NTT's kernels on
    ``row``'s [16, B, n] batch (check_ntt): the bit reversal moves each
    64-byte element in once and out once; the whole transform (the pass
    kernel's work, and the stage route's all log2 n stages) reads the input
    once and writes the output once (the stages also read their n/2-entry
    twiddle table once) and runs (n/2)·log2(n)·B Montgomery products, n·B
    more on the inverse (its 1/n), each 2 x 8^2 multiply-adds."""
    _, batch, n = row["shape"]
    nbytes = 2 * 64 * batch * n
    ops = 0
    if name in ("ntt_butterfly", "ntt_pass"):
        nbytes += 64 * (n // 2) if name == "ntt_butterfly" else 0
        products = (n // 2) * row["stages"] * batch + (n * batch if row["inverse"] else 0)
        ops = 2 * 8 * 8 * products
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def combine_bound_ms(row: dict, clock_mhz: float) -> tuple[float, str]:
    """The least time the card could take for the combine of ``row``
    (check_combine): bytes, one read of the [3, 24, W·S·b] bucket sums and
    one write of the [3, 24, W] window sums; operations, the Fq products
    (g1_ops) of every add the function needs (combine_work's ``add_lanes``:
    the fold and the running sums, not the kernel's scan) and the
    doubling's of every one that doubles."""
    nbytes = 288 * (row["shape"][1] + row["windows"])
    ops = g1_ops("g1_bucket_combine", row["add_lanes"], row["double_lanes"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def accumulate_bound_ms(row: dict, clock_mhz: float) -> tuple[float, str]:
    """The least time the card could take for the accumulate of ``row``
    (check_accumulate): bytes, idx and valid of every cell, a 192-byte
    table row of every valid cell, the three 96-byte output coordinates of
    every lane (and as many in for a starting accumulator); operations, the
    mixed add's Fq products (g1_ops) of every valid cell and the doubling's
    of every cell that doubles."""
    lanes = row["shape"][1]
    cells = row["depth"] * lanes
    nbytes = 9 * cells + 192 * row["valid_cells"] + 288 * lanes * (2 if row["start"] else 1)
    ops = g1_ops("g1_fused_madd", row["valid_cells"], row["double_cells"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def fixed_base_bound_ms(row: dict, clock_mhz: float) -> tuple[float, str]:
    """The least time the card could take for the fixed base of ``row``
    (check_fixed_base): bytes, the 64 bytes of a lane's scalar limbs in and
    its 288 bytes of Jacobian planes out, and the [8192, 36] window table
    read once; operations, the Fq products (g1_ops: 11 multiplies and 5
    squarings) of every add of a row to a point (fixed_base_work's
    ``adds``)."""
    lanes = row["shape"][1]
    nbytes = (64 + 288) * lanes + 8192 * 36 * 4
    ops = g1_ops("g1_fixed_base", row["adds"])
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / (SMS * IMAD_PER_SM_CLOCK * clock_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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
    rng = test_rng()
    srs = timed_step(device, steps, "setup_s", lambda: kzg10.setup(max_degree, rng, device=device))
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
        out = timed_step(device, steps, f"commit_{name}_s", lambda: kzg10.commit(
            srs, poly, degree_bound=bound, hiding_rng=rng if hiding else None))
        comm, rand = out if hiding else (out, None)
        labeled.append([poly, comm, None, bound])
        rands.append(rand)
    point, xi = Fr.rand(rng).value, Fr.rand(rng).value
    values = timed_step(device, steps, "evaluate_s", lambda: [
        dvec.scalar_to_int(dvec.evaluate(p, point)) for p, *_ in labeled])
    for entry, v in zip(labeled, values):
        entry[2] = v
    witness, random_v = timed_step(device, steps, "batch_open_s", lambda: kzg10.batch_open(
        srs, [tuple(e) for e in labeled], point, xi, rands))

    shift_powers = {b: srs.power(srs.max_degree - b) for *_, b in labeled if b is not None}

    def check(vals):
        return kzg10.batch_check(
            srs.first_power(), srs.h, srs.beta_h, srs.max_degree,
            [(None, comm, v, bound) for (_, comm, _, bound), v in zip(labeled, vals)],
            point, witness, xi, gamma_g=srs.gamma_g, random_v=random_v,
            shift_powers=shift_powers)

    accepted = timed_step(device, steps, "batch_check_s", lambda: check(values))
    tampered = list(values)
    tampered[0] = (tampered[0] + 1) % P
    rejected = not check(tampered)
    if not (accepted and rejected):
        raise AssertionError(f"batch_check: accepted={accepted}, rejected tampered={rejected}")

    small = random_poly(host_check_width, len(polys), device)
    comm = timed_step(device, steps, "host_check_commit_s", lambda: kzg10.commit(srs, small))
    expected = msm([srs.power(i) for i in range(host_check_width)], dvec.to_ints(small))
    if comm.comm != expected:
        raise AssertionError("device commitment differs from the host MSM over the SRS")
    return {"max_degree": max_degree, "widths": [w for _, w, _, _ in polys], "steps": steps,
            "batch_check": accepted, "tampered_batch_check": not rejected,
            "host_msm_equal": True}


# ------------------------------------------ checkpoint path and new API --


def check_device_field(device, lanes: int = DEVICE_FIELD_LANES,
                       host_lanes: int = DEVICE_FIELD_HOST_LANES) -> dict:
    """fields.device.DeviceField on [L, lanes] seed-made Fr and Fq vectors
    (0, 1 and p-1 among them): each op against the plain version of its
    kernel on the same card tensors (exact), and against host integers on
    the first ``host_lanes`` lanes."""
    import numpy as np
    import torch

    from simpleworks_tpu_torch.fields.bls12_377 import Fq, Fr
    from simpleworks_tpu_torch.fields.device import DeviceField, from_mont
    from simpleworks_tpu_torch.ops import mont_mul as mm

    out = {}
    for params, seed in ((Fr.PARAMS, 41), (Fq.PARAMS, 42)):
        df = DeviceField(params)
        f, p = df.field, df.p_int
        a, b = field_inputs(f, lanes, seed, device), field_inputs(f, lanes, seed + 10, device)
        b = b.flip(1).contiguous()  # the edge values meet each other
        col = b[:, 7:8]
        zero = torch.zeros_like(a)
        cond = torch.from_numpy(np.arange(lanes) % 3 == 0).to(device)
        e = p - 2
        cases = {
            "add": (df.add(a, b), mm.mod_add_plain(a, b, f)),
            "sub": (df.sub(a, b), mm.mod_sub_plain(a, b, f)),
            "neg": (df.neg(a), mm.mod_sub_plain(zero, a, f)),
            "mul": (df.mul(a, b), mm.mont_mul_plain(a, b, f)),
            "square": (df.square(a), mm.mont_mul_plain(a, a, f)),
            "mul_scalar_mont": (df.mul_scalar_mont(a, col), mm.mont_mul_plain(a, col.expand_as(a), f)),
            "pow_host_exponent": (df.pow_host_exponent(a, e), mm.mont_pow_plain(a, e, f)),
            "select": (df.select(cond, a, b), torch.where(cond[None, :], a, b)),
        }
        x, y = from_mont(a[:, :host_lanes], f), from_mont(b[:, :host_lanes], f)
        c = from_mont(col, f)[0]
        host = {"add": [(u + v) % p for u, v in zip(x, y)], "sub": [(u - v) % p for u, v in zip(x, y)],
                "neg": [-u % p for u in x], "mul": [u * v % p for u, v in zip(x, y)],
                "square": [u * u % p for u in x], "mul_scalar_mont": [u * c % p for u in x],
                "pow_host_exponent": [pow(u, e, p) for u in x],
                "select": [u if k % 3 == 0 else v for k, (u, v) in enumerate(zip(x, y))]}
        rows = {}
        for name, (got, plain) in cases.items():
            equal = bool(torch.equal(got, plain)) and from_mont(got[:, :host_lanes], f) == host[name]
            if not equal:
                raise AssertionError(f"DeviceField.{name} ({params.name}) differs from its plain "
                                     f"version or the host")
            rows[name] = True
        a_eq = a.clone()
        a_eq[:, 5] = b[:, 5]
        flags = {"is_zero": (df.is_zero(a), [u == 0 for u in from_mont(a, f)]),
                 "eq": (df.eq(a, a_eq), [k != 5 or bool(torch.equal(a[:, 5], b[:, 5]))
                                         for k in range(lanes)])}
        for name, (got, want) in flags.items():
            if got.tolist() != want:
                raise AssertionError(f"DeviceField.{name} ({params.name}) is wrong")
            rows[name] = True
        out[params.name] = {"shape": list(a.shape), "host_lanes": host_lanes, "equal": rows}
    return out


def check_g1_device(device, scalars: int = LADDER_SCALARS, bits: int = LADDER_BITS,
                    tree_points: int = TREE_POINTS) -> dict:
    """curves.g1_device on the card: the fixed-base ladder for ``scalars``
    seed-made scalars at ``bits`` bits (0 and 1 among them) against host
    scalar_mul, and tree_reduce of ``tree_points`` seed-made points (the
    identities, doublings and cancellations of g1_inputs mixed in) against
    the host sum, exactly."""
    import numpy as np

    from simpleworks_tpu_torch.curves import g1_device
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P

    rng = np.random.default_rng(43)
    base = G1Point.generator().scalar_mul(int.from_bytes(rng.bytes(32), "little") % P)
    ks = [0, 1] + [int.from_bytes(rng.bytes(32), "little") % P for _ in range(scalars - 2)]
    t0 = time.perf_counter()
    ladder = g1_device.points_from_device(
        g1_device.scalar_mul_fixed_base_batch(base, ks, num_bits=bits, device=device))
    ladder_s = time.perf_counter() - t0
    if ladder != [base.scalar_mul(k % (1 << bits)) for k in ks]:
        raise AssertionError("g1_device.scalar_mul_fixed_base_batch differs from host scalar_mul")
    ins = g1_inputs(tree_points, 44, device)
    t0 = time.perf_counter()
    (total,) = g1_device.points_from_device(g1_device.tree_reduce(ins["p3"]))
    tree_s = time.perf_counter() - t0
    expected = G1Point.identity()
    for pt in ins["p"]:
        expected = expected.add(pt)
    if total != expected:
        raise AssertionError("g1_device.tree_reduce differs from the host sum")
    return {"ladder": {"scalars": scalars, "bits": bits, "seconds": ladder_s, "equal": True},
            "tree_reduce": {"points": tree_points, "seconds": tree_s, "equal": True}}


@contextlib.contextmanager
def checkpoint_env(root: str):
    """Both disk checkpoints on, in ``root``'s srs/ and pk/, for the enclosed
    block (yields that environment); the environment as it was afterwards."""
    keys = ("SWTPU_SRS_DISK_CACHE", "SWTPU_PK_DISK_CACHE", "SWTPU_SRS_CACHE_DIR",
            "SWTPU_PK_CACHE_DIR")
    saved = {k: os.environ.get(k) for k in keys}
    for k in keys[:2]:
        os.environ.pop(k, None)
    os.environ.update(SWTPU_SRS_CACHE_DIR=str(Path(root) / "srs"),
                      SWTPU_PK_CACHE_DIR=str(Path(root) / "pk"))
    try:
        yield dict(os.environ)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def run_checkpoint(device, kept: dict, root: str, timeout_s: float = CHECKPOINT_CHILD_TIMEOUT_S
                   ) -> dict:
    """The checkpoint path, on the Marlin path's SRS and proving key
    (``kept``; no setup or index here): both saved to the disk checkpoints
    under ``root``; then a fresh process (this script with
    CHECKPOINT_CHILD_FLAG, on the same card and directories) loads them
    through universal_setup and index, with no setup and no index work,
    and proves the bench's circuit, vk and proof held to the fixture; then
    the proving-key serde round trip of test_circuit(3, 3) on the card."""
    import os

    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.fields.bls12_377 import Fr
    from simpleworks_tpu_torch.kzg import kzg10

    pk, cs = kept["pk"], kept["cs"]
    srs = pk.srs
    steps: dict[str, float] = {}
    with checkpoint_env(root) as env:
        rng = marlin.generate_rand()
        key = (srs.max_degree, Fr.rand(rng).value, Fr.rand(rng).value)  # setup's memo key
        timed_step(device, steps, "save_srs_s", lambda: kzg10._save_srs_disk(key, srs))
        matrix_fp = marlin._matrix_fingerprint(cs, cs.to_matrices())
        pk_path = marlin._pk_disk_path(srs, matrix_fp)
        timed_step(device, steps, "save_pk_s", lambda: marlin._save_pk_disk(pk_path, pk))
    sizes = {}
    for sub, prefix in (("srs", "torch_srs_"), ("pk", "torch_pk_")):
        found = sorted((Path(root) / sub).glob(f"{prefix}*.npz"))
        if len(found) != 1:
            raise AssertionError(f"the {sub} checkpoint was not written: {found}")
        sizes[f"{sub}_bytes"] = found[0].stat().st_size
    emit({"checkpoint_saved": {**steps, **sizes}})

    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), CHECKPOINT_CHILD_FLAG],
                          capture_output=True, text=True, env=env, timeout=timeout_s,
                          cwd=str(Path(__file__).resolve().parent))
    child_s = time.perf_counter() - t0
    lines = proc.stdout.strip().splitlines()
    last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
    if proc.returncode != 0 or "checkpoint_child" not in last:
        sys.stderr.write(proc.stdout[-4000:] + proc.stderr[-4000:])
        raise AssertionError(f"the checkpoint child exited {proc.returncode} without a result")
    child = last["checkpoint_child"]
    serde = run_serde(device)
    return {**steps, **sizes, "child_wall_s": child_s, "child": child,
            "child_launches": child["launches"], "serde": serde}


def checkpoint_child(device, reference: dict) -> dict:
    """The checkpoint path's second process: universal_setup and index of
    the bench's sizes and circuit must load from the disk checkpoints (no
    call of the SRS build, no index commit), then the circuit is
    synthesised and proved on the bench's draws, and the vk and proof held
    to the fixture."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.kzg import kzg10
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof, serialize_verifying_key
    from simpleworks_tpu_torch.ops import _build

    counts = {"setup": 0, "commit": 0}
    build, commit = kzg10._setup_uncached, kzg10.commit

    def counted(key, fn):
        def wrapper(*args, **kwargs):
            counts[key] += 1
            return fn(*args, **kwargs)
        return wrapper

    kzg10._setup_uncached, kzg10.commit = counted("setup", build), counted("commit", commit)
    steps: dict[str, float] = {}
    srs = timed_step(device, steps, "load_srs_s", lambda: marlin.universal_setup(
        *SRS_SIZES, marlin.generate_rand(), device=device))
    emit({"load_srs_s": steps["load_srs_s"]})
    cs = timed_step(device, steps, "synthesis_s", schnorr_circuit)
    pk, vk = timed_step(device, steps, "load_pk_s", lambda: marlin.index(srs, cs))
    emit({"load_pk_s": steps["load_pk_s"]})
    work = dict(counts)
    if work != {"setup": 0, "commit": 0}:
        raise AssertionError(f"the second process set up or indexed instead of loading: {work}")
    _build.reset_launches()
    proof = timed_step(device, steps, "prove_cold_s", lambda: marlin.prove(pk, cs))
    launches = dict(_build.LAUNCHES)
    emit({"prove_cold_s": steps["prove_cold_s"]})
    emit({"launches": launches})
    same = check_reference(reference, serialize_verifying_key(vk), serialize_proof(proof))
    if not marlin.verify(vk, [], proof):
        raise AssertionError("the loaded key's proof does not verify")
    return {"steps": steps, "work": work, "launches": launches, "reference": same,
            "srs_max_degree": srs.max_degree}


def run_serde(device) -> dict:
    """serialize_proving_key -> deserialize_proving_key(device) -> prove, for
    test_circuit(3, 3) at SERDE_SRS_SIZES on the card: the bytes read back
    serialize to the same bytes, and the read-back key's proof equals the
    original key's.  Both keys live on the card, and the key read back
    proves there: FrVec.from_std_array onto the card, the card's
    index_from_polys and its prove launch the field, NTT and MSM kernels."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.examples import test_circuit
    from simpleworks_tpu_torch.marlin import serialization as serde
    from simpleworks_tpu_torch.ops import _build

    steps: dict[str, float] = {}
    cs = test_circuit.synthesize(3, 3)
    srs = marlin.universal_setup(*SERDE_SRS_SIZES, marlin.generate_rand(), device=device)
    pk, vk = marlin.index(srs, cs)
    proof = serde.serialize_proof(marlin.prove(pk, cs))
    blob = timed_step(device, steps, "serialize_s", lambda: serde.serialize_proving_key(pk))
    before = dict(_build.LAUNCHES)
    pk2 = timed_step(device, steps, "deserialize_s",
                     lambda: serde.deserialize_proving_key(blob, device=device))
    if pk2.srs.device != device or serde.serialize_proving_key(pk2) != blob:
        raise AssertionError("the proving key read back does not serialize to its bytes")
    proof2 = marlin.prove(pk2, cs)
    launches = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
    if serde.serialize_proof(proof2) != proof or not marlin.verify(vk, [], proof2):
        raise AssertionError("the proving key read back proves other bytes")
    if pk.device != device or pk2.device != device:
        raise AssertionError(f"the serde's keys live on {pk.device} and {pk2.device}, not {device}")
    if device.type == "cuda" and not all(launches[k] for k in ("mont_mul", "ntt_pass",
                                                                "g1_fused_madd")):
        raise AssertionError(f"the key read back did not prove on the card: {launches}")
    return {"sizes": list(SERDE_SRS_SIZES), "powers": srs.num_powers, "bytes": len(blob),
            "steps": steps, "equal": True, "key_device": str(pk2.device),
            "read_back_launches": launches}


def check_native(device, ntt_log: int = NATIVE_NTT_LOG, msm_log: int = NATIVE_MSM_LOG,
                 fixed_base: int = NATIVE_FIXED_BASE_POWERS, max_degree: int = MAX_DEGREE) -> dict:
    """The host native runtime (simpleworks_tpu_torch/native over
    csrc/host_native.cpp): its g++ build, then its results held against the
    card's on the same inputs, exactly, with both times: the NTT at
    2^ntt_log (dvec.fft of a CPU tensor against a CUDA one), the batch-affine
    MSM against msm_device_mont at 2^msm_log points of the KZG path's SRS
    (its memo), and the fixed base against that SRS's first powers."""
    import numpy as np
    import torch

    from simpleworks_tpu_torch import native
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.fields import dvec
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
    from simpleworks_tpu_torch.fields.bls12_377 import Fr
    from simpleworks_tpu_torch.kzg import kzg10
    from simpleworks_tpu_torch.ops import _build
    from simpleworks_tpu_torch.ops.msm_pippenger import msm_device_mont
    from simpleworks_tpu_torch.utils.rng import test_rng

    cpu = torch.device("cpu")
    if not native.available():
        raise AssertionError("the native runtime is unavailable (no C++ compiler on PATH)")
    lib = native._lib()  # built beside the nvcc builds
    out = {"gxx_seconds": _build.host_build_seconds, "library": Path(lib._name).name, "compiler": native.compiler(),
           "host_cpu": _build.cpu_model(), "host_threads": native.threads(),
           "cpu_count": os.cpu_count()}

    n = 1 << ntt_log
    coeffs = random_poly(n, 500, cpu)
    host = dvec.fft(coeffs, n)
    card = dvec.fft(coeffs.to(device), n)
    if not torch.equal(host, card.cpu()):
        raise AssertionError(f"the native NTT differs from the card's at 2^{ntt_log}")
    on_card = coeffs.to(device)
    out["ntt"] = {"n": n, "equal": True, "host_ms": time_ms(lambda: dvec.fft(coeffs, n), cpu, 3),
                  "card_ms": time_ms(lambda: dvec.fft(on_card, n), device, 3)}

    srs = kzg10.setup(max_degree, test_rng(), device=device)
    m = 1 << msm_log
    rows = native.planes_to_native(srs.powers_xy[:, :, :m])
    scalars = random_poly(m, 501, cpu)
    card_scalars = scalars.to(device)
    if kzg10.host_msm(rows, scalars) != msm_device_mont(srs.powers_xy, card_scalars):
        raise AssertionError(f"the native MSM differs from msm_device_mont at 2^{msm_log}")
    out["msm"] = {"n": m, "equal": True,
                  "host_ms": time_ms(lambda: kzg10.host_msm(rows, scalars), cpu, 3),
                  "card_ms": time_ms(lambda: msm_device_mont(srs.powers_xy, card_scalars),
                                     device, 3)}

    tau = Fr.rand(test_rng()).value  # the KZG path's setup's first draw
    tau_mont = native.ints_to_limbs64([tau * Fr.PARAMS.montgomery_r % P], 4)
    std = native.fr_from_mont_arr(native.fr_powers_arr(tau_mont, fixed_base))
    g = G1Point.generator()

    def fixed():
        return native.g1_normalize_arr(native.g1_fixed_base_arr(g, std))

    if not np.array_equal(native.native_to_planes_u16(fixed()),
                          srs.powers_xy[:, :, :fixed_base].cpu().numpy().astype(np.uint16)):
        raise AssertionError("the native fixed base differs from the card setup's powers")
    out["fixed_base"] = {"powers": fixed_base, "equal": True, "host_ms": time_ms(fixed, cpu, 3)}
    return out


def run_small_prove(device, sizes=SMALL_PROVE_SRS_SIZES, circuit=SMALL_PROVE_CIRCUIT) -> dict:
    """The card against the host at a small size: the reference's wedge
    circuit (manual_constraints.synthesize(5, 5)) set up, indexed and proved
    on the card (its key there, its prove launching the field, NTT and MSM
    kernels) and on the CPU (the host native runtime); equal proof bytes, and
    each side's warm prove timed.  The port has no size routing: these two
    times are what a size gate, with thresholds set from the card, would
    weigh."""
    import torch

    from simpleworks_tpu_torch import marlin, native
    from simpleworks_tpu_torch.examples import manual_constraints
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof
    from simpleworks_tpu_torch.ops import _build

    cpu = torch.device("cpu")
    public = [circuit[0]]
    steps: dict[str, float] = {}
    blobs, launches = {}, {}
    for dev in (device, cpu):
        cs = manual_constraints.synthesize(*circuit)
        srs = timed_step(dev, steps, f"{dev.type}_setup_s", lambda: marlin.universal_setup(
            *sizes, marlin.generate_rand(), device=dev))
        pk, vk = timed_step(dev, steps, f"{dev.type}_index_s", lambda: marlin.index(srs, cs))
        if pk.device != dev:
            raise AssertionError(f"the wedge circuit's key lives on {pk.device}, not {dev}")
        marlin.prove(pk, cs)  # cold: the transforms' twiddles
        before = dict(_build.LAUNCHES)
        proof = timed_step(dev, steps, f"{dev.type}_prove_s", lambda: marlin.prove(pk, cs))
        launches[dev.type] = {k: v - before[k] for k, v in _build.LAUNCHES.items()}
        if not marlin.verify(vk, public, proof):
            raise AssertionError(f"the wedge circuit's proof on {dev} does not verify")
        blobs[dev.type] = serialize_proof(proof)
    if blobs[device.type] != blobs["cpu"]:
        raise AssertionError("the wedge circuit's proof bytes differ between the card and the CPU")
    if any(launches["cpu"].values()):
        raise AssertionError(f"the CPU's prove launched kernels: {launches['cpu']}")
    if device.type == "cuda" and not all(launches[device.type][k] for k in (
            "mont_mul", "ntt_pass", "g1_fused_madd")):
        raise AssertionError(f"the card's prove did not launch its kernels: {launches}")
    return {"sizes": list(sizes), "n": vk.info.domain_h_size, "m": vk.info.domain_k_size,
            "card_launches": launches[device.type], "equal_bytes": True, "steps": steps,
            "host_threads": native.threads()}


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def run_multihost(device, expected: bytes, ranks: int = MULTIHOST_RANKS,
                  timeout_s: float = MULTIHOST_TIMEOUT_S) -> dict:
    """parallel/multihost.py on the card: ``ranks`` processes (this script
    with MULTIHOST_CHILD_FLAG) join a gloo job on tcp://localhost, each
    shards the sharded path's prove over its card MULTIHOST_LOCAL_DEVICES
    times (a global list of ranks x that), and each proof's bytes must equal
    the single process's (``expected``, the sharded path's)."""
    init = f"tcp://localhost:{free_port()}"
    script = str(Path(__file__).resolve())
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, script, MULTIHOST_CHILD_FLAG, init, str(r)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              cwd=str(Path(script).parent)) for r in range(ranks)]
    results = []
    try:
        for proc in procs:
            out, err = proc.communicate(timeout=timeout_s)
            lines = out.strip().splitlines()
            last = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
            if proc.returncode != 0 or "multihost_child" not in last:
                sys.stderr.write(out[-4000:] + err[-4000:])
                raise AssertionError(f"a multihost rank exited {proc.returncode} without a result")
            results.append(last["multihost_child"])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    digest = hashlib.sha256(expected).hexdigest()
    if any(r["proof_sha256"] != digest for r in results):
        raise AssertionError("a rank's proof bytes differ from the single process's")
    return {"ranks": ranks, "local_devices": MULTIHOST_LOCAL_DEVICES, "backend": "gloo",
            "wall_s": time.perf_counter() - t0, "equal_bytes": True, "children": results}


def multihost_child(device, init: str, rank: int, ranks: int = MULTIHOST_RANKS,
                    local: int = MULTIHOST_LOCAL_DEVICES, steps: int = CHAIN_STEPS,
                    sizes=CHAIN_SRS_SIZES) -> dict:
    """One rank of the multihost phase: the sharded path's circuit proved
    with the prover's transforms and commits over the global device list."""
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof
    from simpleworks_tpu_torch.ops import accel
    from simpleworks_tpu_torch.parallel import msm_sharded, multihost, ntt_sharded

    t0 = time.perf_counter()
    multihost.initialize(init, world_size=ranks, rank=rank, timeout_s=MULTIHOST_TIMEOUT_S)
    seconds: dict[str, float] = {"join_s": time.perf_counter() - t0}
    try:
        cs = square_add_chain(steps)
        srs = timed_step(device, seconds, "setup_s", lambda: marlin.universal_setup(
            *sizes, marlin.generate_rand(), device=device))
        pk, vk = timed_step(device, seconds, "index_s", lambda: marlin.index(srs, cs))
        targets = {"ntt": (ntt_sharded, "sharded_transform"), "msm": (msm_sharded, "sharded_msm"),
                   "msm_native": (msm_sharded, "sharded_msm_native")}  # the latter: CPU keys
        accel.set_prover_devices([device] * local)
        try:
            devices = len(accel.prover_devices())
            with calls_timed(device, targets) as calls:
                proof = timed_step(device, seconds, "prove_s", lambda: marlin.prove(pk, cs))
        finally:
            accel.set_prover_devices(None)
        counts = {key: len(rows) for key, rows in calls.items()}
        counts["msm"] += counts.pop("msm_native")
        if not all(counts.values()) or devices != ranks * local:
            raise AssertionError(f"rank {rank}: sharded calls {counts} over {devices} devices")
        if not marlin.verify(vk, [PUBLIC_INPUT], proof):
            raise AssertionError(f"rank {rank}'s proof does not verify")
        blob = serialize_proof(proof)
    finally:
        multihost.shutdown()
    return {"rank": rank, "global_devices": devices, "sharded_calls": counts, "steps": seconds,
            "proof_sha256": hashlib.sha256(blob).hexdigest()}


def smi(query: str) -> str:
    out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(argv: list[str]) -> int:
    import torch

    multihost_rank = argv[:1] == [MULTIHOST_CHILD_FLAG] and len(argv) == 3
    if argv not in ([], ["--profile"], [CHECKPOINT_CHILD_FLAG]) and not multihost_rank:
        print("usage: chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)", file=sys.stderr)
        return 1
    try:
        from simpleworks_tpu_torch.kzg import kzg10
        from simpleworks_tpu_torch.ops import _build
    except ImportError as exc:
        print(f"chip_smoke: run from the root of a checkout of the repository ({exc})",
              file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    reference = json.loads(REFERENCE_FIXTURE.read_text())
    workloads = json.loads(WORKLOAD_FIXTURE.read_text())
    if argv == [CHECKPOINT_CHILD_FLAG]:
        _build.build_all()
        emit({"checkpoint_child": checkpoint_child(device, reference)})
        return 0
    if multihost_rank:
        emit({"multihost_child": multihost_child(device, argv[1], int(argv[2]))})
        return 0
    # the disk checkpoints stay off on every path but the checkpoint path's,
    # so that no path times a load as its setup or index
    os.environ.update(SWTPU_SRS_DISK_CACHE="0", SWTPU_PK_DISK_CACHE="0")

    script_t0 = time.perf_counter()
    print(smi("name,power.limit"), flush=True)
    clock_mhz = float(smi("clocks.max.sm").split()[0])

    from simpleworks_tpu_torch import native

    t0 = time.perf_counter()
    # the host runtime's g++ build runs beside the nvcc builds
    host_build = threading.Thread(target=native._lib)
    host_build.start()
    libraries = _build.build_all()
    for stem in _build.SIGNATURES:
        _build.library(stem)
    host_build.join()
    emit({"build": {"seconds": time.perf_counter() - t0,
                    "nvcc_seconds": _build.build_seconds - _build.host_build_seconds,
                    "gxx_seconds": _build.host_build_seconds,
                    "libraries": [lib.name for lib in libraries]}})

    checks = check_kernels(device)
    emit({"kernel_checks": checks})
    g1_checks = check_g1(device)
    emit({"g1_checks": g1_checks})
    checks.update(g1_checks)
    checks["g1_fixed_base"] = [check_fixed_base(device)]
    emit({"fixed_base_check": checks["g1_fixed_base"][0]})
    ntt_checks = check_ntt(device)
    emit({"ntt_checks": ntt_checks})
    checks["ntt_reduce"] = [ntt_checks["reduce"]]
    checks["ntt_bitrev"] = ntt_checks["bitrev"]
    checks["ntt_butterfly"] = ntt_checks["butterfly"]
    checks["ntt_pass"] = ntt_checks["pass"]
    emit({"device_field_checks": check_device_field(device)})
    emit({"g1_device_checks": check_g1_device(device)})

    def drive(label, path, fn):
        """Runs one path with the launch counts set to 0 just before it and
        read just after; every kernel of ``path`` must have launched."""
        _build.reset_launches()
        torch.cuda.reset_peak_memory_stats(device)
        start_bytes = torch.cuda.memory_allocated(device)  # what earlier paths still hold
        t0 = time.perf_counter()
        result = fn()
        torch.cuda.synchronize(device)
        result["seconds"] = time.perf_counter() - t0
        result["launches"] = dict(_build.LAUNCHES)
        for k, v in result.get("child_launches", {}).items():  # a second process's
            result["launches"][k] += v
        result["peak_memory_bytes"] = torch.cuda.max_memory_allocated(device)
        result["start_memory_bytes"] = start_bytes
        idle = [k for k in path if result["launches"][k] <= 0]
        if idle:
            raise AssertionError(f"kernels never launched on the {label} path: {idle}")
        return result

    def drive_counting_pow(label, path, fn):
        """drive(), with the Fermat pow's launches counted by caller: all of
        them in dvec.inv and normalize_affine, none in an accumulate row."""
        with pow_launches_by_caller({}) as counts:
            result = drive(label, path, fn)
        result["mont_pow_by_caller"] = counts
        if counts["g1_limb.affine_madd"] or sum(counts.values()) != result["launches"]["mont_pow"]:
            raise AssertionError(f"the {label} path ran the Fermat pow elsewhere than dvec.inv "
                                 f"and normalize_affine: {counts}, {result['launches']}")
        return result

    def drive_affine_prove(fn, madd_run):
        """drive() of the prove forced to the affine accumulate, which must
        show that it took that route: no accumulate kernel, the pow in
        affine_madd's rows, and more pows than the madd prove's."""
        with pow_launches_by_caller({}) as counts:
            result = drive("Marlin, affine accumulate", ["mont_pow"], fn)
        result["mont_pow_by_caller"] = counts
        launches = result["launches"]
        if launches["g1_fused_madd"] or not counts["g1_limb.affine_madd"] \
                or launches["mont_pow"] <= madd_run["launches"]["mont_pow"]:
            raise AssertionError(f"the prove forced to the affine accumulate did not take it: "
                                 f"{counts}, {launches}")
        return result

    # the KZG path: digits (mont_mul), the SRS's normalisation (mont_pow),
    # the setup's fixed-base powers, the accumulate and the combine; the MSM
    # path runs no setup (the SRS is the KZG path's memo)
    msm = ["g1_fused_madd", "g1_bucket_combine"]
    kzg = ["mont_mul", "mont_pow", "g1_fixed_base", *msm]
    prover = [*FIELD_KERNELS, "ntt_pass", "g1_fixed_base", *msm]
    paths = {}
    paths["kzg"] = drive_counting_pow("KZG", kzg, lambda: run_slice(device))
    emit({"kzg_slice": paths["kzg"]})
    paths["msm"] = drive("MSM", msm, lambda: run_msm(device))
    emit({"msm": paths["msm"]})
    accumulated: list = []
    accumulate = check_accumulate(device, keep=accumulated)
    emit({"accumulate_check": accumulate})
    checks["g1_fused_madd"].append(accumulate)
    checks["g1_bucket_combine"] = check_combine(device, accumulated)
    del accumulated
    emit({"combine_checks": checks["g1_bucket_combine"]})
    # the host runtime against the card, on the KZG path's SRS (its memo)
    emit({"native": check_native(device)})
    kzg10._SRS_MEMO.clear()  # the Marlin path's setup is timed, not read from the memo
    paths["chain"] = drive_counting_pow("chain", prover, lambda: run_chain(device))
    emit({"chain": paths["chain"]})
    kept: dict = {}
    paths["marlin"] = drive_counting_pow(
        "Marlin", prover, lambda: run_marlin(device, reference=reference, keep=kept))
    emit({"marlin": paths["marlin"]})
    for label in ("chain", "marlin"):
        warm = paths[label]["prove_warm_launches"]
        if warm["g1_fused_add"] or warm["g1_fixed_base"] or warm["g1_bucket_combine"] <= 0:
            raise AssertionError(f"the {label} path's warm prove ran the fused add, the fixed "
                                 f"base or no combine: {warm}")
    # the old default in the same call, outside the paths' counts
    emit({"marlin_affine": drive_affine_prove(
        lambda: run_affine_prove(device, kept["pk"], kept["cs"], kept["proof"]),
        paths["marlin"])})
    # the checkpoint path: the Marlin path's SRS and key saved, then loaded
    # by a second process; the small proving-key serde
    with tempfile.TemporaryDirectory(prefix="swtpu_checkpoints_") as root:
        paths["checkpoint"] = drive("checkpoint", prover,
                                    lambda: run_checkpoint(device, kept, root))
    del kept
    emit({"checkpoint": paths["checkpoint"]})
    # the two workloads at the reference's parameters; the merkle tree's SRS
    # draws the Marlin path's tau and gamma, so it is built anew, not read
    # from the memo
    kzg10._SRS_MEMO.clear()
    paths["merkle"] = drive_counting_pow(
        "merkle", prover, lambda: run_merkle(device, reference=workloads["merkle"]))
    emit({"merkle": paths["merkle"]})
    paths["payments"] = drive_counting_pow(
        "payments", prover, lambda: run_payments(device, reference=workloads["payments"]))
    emit({"payments": paths["payments"]})
    # the parallel planes: block validation at the reference's parameters,
    # the CLI's proof pipeline, and the chain path's prove sharded over the
    # card repeated; each builds its SRS anew (the setup's add launches)
    kzg10._SRS_MEMO.clear()
    paths["block"] = drive_counting_pow("block", prover, lambda: run_block(device))
    emit({"block": paths["block"]})
    kzg10._SRS_MEMO.clear()
    paths["pipeline"] = drive_counting_pow("pipeline", prover, lambda: run_pipeline(device))
    emit({"pipeline": paths["pipeline"]})
    kzg10._SRS_MEMO.clear()
    sharded_kept: dict = {}
    paths["sharded"] = drive_counting_pow("sharded", prover,
                                          lambda: run_sharded(device, keep=sharded_kept))
    emit({"sharded": paths["sharded"]})
    emit({"small_prove": run_small_prove(device)})
    emit({"multihost": run_multihost(device, sharded_kept["proof_bytes"])})
    emit({"pin": run_pin(device)})
    emit({"elapsed": {"seconds": time.perf_counter() - script_t0}})

    from simpleworks_tpu_torch.fields.device import FQ, FR

    kernels = []
    for name, rows in checks.items():
        # the Fq shape for the binary ops and the add, the Fr pow (its widest
        # row checked on every lane), the group's accumulate and combine
        main_row = ([r for r in rows if "plain_shape" not in r] or rows)[-1]
        for row in rows:
            # the pow's exponent is the Fermat one of the row's field
            exponent = (FR if row["shape"][0] == 16 else FQ).p - 2 if name == "mont_pow" else None
            if name == "mont_pow":
                work = pow_work(exponent, row["shape"][0] // 2)
                row.update(squarings=work["squarings"], multiplies=work["multiplies"])
            if name == "g1_bucket_combine":
                row["bound_ms"], row["bound_by"] = combine_bound_ms(row, clock_mhz)
            elif name == "g1_fixed_base":
                row["bound_ms"], row["bound_by"] = fixed_base_bound_ms(row, clock_mhz)
            elif name in BUTTERFLY_KERNELS:
                row["bound_ms"], row["bound_by"] = butterfly_bound_ms(name, row, clock_mhz)
            elif "depth" in row:
                row["bound_ms"], row["bound_by"] = accumulate_bound_ms(row, clock_mhz)
            else:
                row["bound_ms"], row["bound_by"] = bound_ms(name, row["shape"], clock_mhz,
                                                            exponent, row.get("double_lanes", 0))
        by_path = {label: run["launches"][name] for label, run in paths.items()}
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name], "replaces": REPLACES[name],
            **({"scan": SCANS[name]} if name in SCANS else {}),
            "launches": sum(by_path.values()),
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
            "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
            "library_ms": main_row.get("library_ms"),
            "shape": main_row["shape"],
            **({"plain_shape": main_row["plain_shape"]} if "plain_shape" in main_row else {}),
            "equal": all(r["equal"] for r in rows),
            "launches_by_path": by_path,
            "shapes": [{k: r[k] for k in ("shape", "depth", "windows", "segments", "buckets", "ms",
                                          "plain_ms", "plain_shape", "checked_lanes", "route_ms",
                                          "inverse", "stages", "passes", "stage_route_ms",
                                          "library_ms", "bound_ms", "registers", "local_bytes")
                        if k in r}
                       for r in rows],
        })
    if any(k["launches"] <= 0 for k in kernels if k["name"] not in OFF_PATH):
        raise AssertionError("a kernel launched on no path")
    if any(k["launches"] for k in kernels if k["name"] in OFF_PATH):
        raise AssertionError(f"a path launched a kernel that runs on no path: {OFF_PATH}")
    emit({"kernels": kernels})
    if argv == ["--profile"]:
        emit({"profile": profile_prove(device)})

    emit({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

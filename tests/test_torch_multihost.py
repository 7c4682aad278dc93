"""parallel/multihost.py on torch.distributed: the put/fetch helpers in a
world of one (gloo, a file:// rendezvous under tmp_path), the sharded planes
inside such a job, and tests/test_parallel.py::test_prove_bytes_multiprocess
on the port: two processes, each with four CPU devices, prove the chain's
bytes of a single process (slow: run with ``pytest -m slow
tests/test_torch_multihost.py``)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from simpleworks_tpu_torch import marlin
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.marlin.serialization import serialize_proof
from simpleworks_tpu_torch.ops import accel
from simpleworks_tpu_torch.parallel import msm_sharded, multihost, ntt_sharded

os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # more threads only contend with the other test workers

ROOT = Path(__file__).resolve().parent.parent
CHILD = Path(__file__).resolve().parent / "torch_multihost_child.py"
CPU = torch.device("cpu")
#: the two children together, setup to proof; they run one sharded prove
#: each of the 120-step chain (~10 s on one core)
CHILD_TIMEOUT_S = 600


@pytest.fixture
def world_of_one(tmp_path):
    multihost.initialize(f"file://{tmp_path / 'rendezvous'}", world_size=1, rank=0)
    try:
        yield
    finally:
        multihost.shutdown()
    assert not multihost.in_job()


def seeded(n: int, seed: int) -> list[int]:
    g = torch.Generator().manual_seed(seed)
    return [int(v) % P for v in torch.randint(0, 1 << 62, (n,), generator=g)]


def test_put_and_fetch_in_a_world_of_one(world_of_one):
    assert multihost.in_job() and not multihost.is_multiprocess()
    assert (multihost.rank(), multihost.world_size()) == (0, 1)
    devices = multihost.global_devices(["cpu"] * 3)
    assert devices == [CPU] * 3
    x = torch.arange(20).reshape(2, 10)
    parts = multihost.put_global(x, devices, dim=1)
    assert [p.shape[1] for p in parts] == [4, 4, 2]
    assert torch.equal(torch.cat(parts, dim=1), x)
    assert [p.shape[1] for p in multihost.put_global(x[:, :7], devices + [CPU], dim=1)] == \
        [2, 2, 2, 1]
    fetched = multihost.fetch_global([p[:, :2] * 2 for p in parts])
    assert all(torch.equal(f, p[:, :2] * 2) for f, p in zip(fetched, parts))
    assert multihost.put_global(x, [None, CPU], dim=1)[0] is None


def test_sharded_planes_inside_a_job(world_of_one):
    """The sharded NTT and MSM gather through the collective and give the
    unsharded values."""
    n = 256
    a = dvec.from_ints(seeded(n, 1), CPU)
    assert torch.equal(ntt_sharded.sharded_transform(["cpu"] * 4, a), dvec.fft(a, n))
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.ops import g1_limb

    g = G1Point.generator()
    x, y, _ = g1_limb.points_to_limb_major_affine([g.scalar_mul(i + 1) for i in range(30)], CPU)
    coeffs = dvec.from_ints(seeded(25, 2), CPU)
    planes = torch.stack([x, y])
    expected = msm_sharded.kzg10.device_msm(planes, coeffs, offset=3)
    assert msm_sharded.sharded_msm(["cpu"] * 4, planes, coeffs, offset=3) == expected


def square_chain(n_constraints: int):
    sys.path.insert(0, str(CHILD.parent))
    try:
        from torch_multihost_child import square_chain as build
    finally:
        sys.path.pop(0)
    return build(n_constraints)


@pytest.mark.slow
def test_prove_bytes_two_processes(tmp_path, monkeypatch):
    """Two processes join a gloo job, shard the prove over the global list of
    2 × 4 CPU devices, and both print the single process's proof bytes."""
    monkeypatch.setenv("SWTPU_SRS_DISK_CACHE", "0")
    monkeypatch.setenv("SWTPU_PK_DISK_CACHE", "0")
    cs, x = square_chain(120)
    srs = marlin.universal_setup(128, 128, 128, marlin.generate_rand(), device=CPU)
    pk, vk = marlin.index(srs, cs)
    proof = marlin.prove(pk, cs)
    expected = serialize_proof(proof)
    assert marlin.verify(vk, [x], proof)

    init = f"file://{tmp_path / 'rendezvous'}"
    env = {**os.environ, "PYTHONPATH": str(ROOT) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    procs = [subprocess.Popen([sys.executable, str(CHILD), init, str(rank)], cwd=ROOT, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for rank in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=CHILD_TIMEOUT_S)
            assert p.returncode == 0, err[-3000:]
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for out in outs:
        lines = [line for line in out.splitlines() if line.startswith("PROOF_HEX:")]
        assert lines, out[-2000:]
        assert bytes.fromhex(lines[-1][len("PROOF_HEX:"):]) == expected
    assert accel.prover_devices() is None

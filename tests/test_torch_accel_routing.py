"""The port's routing (simpleworks_tpu_torch/ops/accel.py): a key stays on the
device its caller resolved, so the host route (the native runtime) runs
when the caller names the CPU and never for an SRS on another device; the
sharded gates by size; and tests/test_accel_routing.py's claim on the port:
every route is proof-invisible, its proof bytes equal to the JAX package's
``marlin.prove``.  A prove on the CPU never asks for a card."""

import os

import pytest
import torch

from simpleworks_tpu import marlin as ref_marlin
from simpleworks_tpu.examples import manual_constraints as ref_manual
from simpleworks_tpu.fields.bls12_377 import ConstraintF as RefF
from simpleworks_tpu.marlin import serialization as ref_serde
from simpleworks_tpu.r1cs.constraint_system import ONE as REF_ONE
from simpleworks_tpu.r1cs.constraint_system import ConstraintSystem as RefCS
from simpleworks_tpu_torch import marlin
from simpleworks_tpu_torch.errors import SimpleworksError
from simpleworks_tpu_torch.examples import manual_constraints
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
from simpleworks_tpu_torch.kzg import kzg10
from simpleworks_tpu_torch.marlin import serialization as serde
from simpleworks_tpu_torch.ops import accel
from simpleworks_tpu_torch.r1cs.constraint_system import ONE, ConstraintSystem

os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # more threads only contend with the other test workers

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _no_disk_checkpoints():
    """The disk checkpoints off: every setup and index of this file is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_SRS_DISK_CACHE", "0")
        mp.setenv("SWTPU_PK_DISK_CACHE", "0")
        yield


def square_chain(cs_cls, one, field, n_constraints: int, x: int = 3):
    """tests/test_accel_routing.py's mid-size circuit: x public, w_0 = x,
    w_{i+1} = w_i²."""
    cs = cs_cls(field)
    a = cs.new_input_variable(x)
    cur, cur_val = cs.new_witness_variable(x), x
    cs.enforce_constraint(cs.lc((1, a)) - cs.lc((1, cur)), cs.lc((1, one)), cs.lc())
    for _ in range(n_constraints):
        nxt_val = cur_val * cur_val % P
        nxt = cs.new_witness_variable(nxt_val)
        cs.enforce_constraint(cs.lc((1, cur)), cs.lc((1, cur)), cs.lc((1, nxt)))
        cur, cur_val = nxt, nxt_val
    return cs


def test_sharded_gates_by_size():
    """The only routing by size left: with a device list set, transforms
    from SHARDED_NTT_THRESHOLD and MSMs from SHARDED_MSM_THRESHOLD points
    shard; with none set (one device), nothing does."""
    assert (accel.SHARDED_NTT_THRESHOLD, accel.SHARDED_MSM_THRESHOLD) == (1 << 14, 1 << 16)
    assert accel.prover_devices() is None
    assert not accel.use_sharded_ntt(1 << 30) and not accel.use_sharded_msm(1 << 30)
    accel.set_prover_devices(["cpu", "cpu"])
    try:
        assert accel.prover_devices() == [CPU, CPU]
        assert not accel.use_sharded_ntt((1 << 14) - 1) and accel.use_sharded_ntt(1 << 14)
        assert not accel.use_sharded_msm((1 << 16) - 1) and accel.use_sharded_msm(1 << 16)
    finally:
        accel.set_prover_devices(None)
    assert accel.prover_devices() is None


def test_no_host_copy_of_a_device_srs():
    """An SRS off the CPU keeps no host rows: asking for them raises, so no
    route can move its MSMs to the host.  A CPU SRS makes them once."""
    meta = kzg10.UniversalSRS(torch.empty((2, 24, 4), dtype=torch.int32, device="meta"),
                              None, None, [])
    assert meta.device.type == "meta"
    with pytest.raises(SimpleworksError):
        meta.host_powers()
    srs = marlin.universal_setup(4, 4, 8, marlin.generate_rand(), device=CPU)
    assert srs.device == CPU and srs.host_powers() is srs.host_powers()
    assert srs.host_powers().shape == (srs.num_powers, 18)


def test_small_prove_never_asks_for_a_card(monkeypatch):
    """tests/test_wedge_proof.py::test_small_prove_never_touches_device on
    the port: with the CPU named, the setup, index and prove of the wedge
    circuit never ask PyTorch for a card."""
    def bomb():
        raise AssertionError("asked for a CUDA card")

    monkeypatch.setattr(torch.cuda, "is_available", bomb)
    cs = manual_constraints.synthesize(5, 5)
    srs = marlin.universal_setup(100, 25, 300, marlin.generate_rand(), device=CPU)
    pk, vk = marlin.index(srs, cs)
    assert pk.device == CPU
    assert marlin.verify(vk, [5], marlin.prove(pk, cs))


CASES = {
    # tests/test_accel_routing.py:29 and :52 (the mid-size case is slow, as
    # the reference's file is: ~14 s, and the small case keeps its coverage)
    "small": ((100, 25, 300), lambda: manual_constraints.synthesize(3, 3),
              lambda: ref_manual.synthesize(3, 3), [3]),
    "midsize": ((1000, 250, 3000), lambda: square_chain(ConstraintSystem, ONE, ConstraintF, 900),
                lambda: square_chain(RefCS, REF_ONE, RefF, 900), [3]),
}


@pytest.mark.parametrize("case", ["small", pytest.param("midsize", marks=pytest.mark.slow)])
def test_routing_is_proof_invisible(monkeypatch, case):
    """The native host route, and for the small circuit the plain route
    (``SWTPU_NATIVE=0``), prove the JAX package's host-prover bytes (the
    mid-size circuit's extra prove would cost tier-1 ~4 s more)."""
    sizes, build, ref_build, public = CASES[case]
    with monkeypatch.context() as mp:
        mp.setenv("SWTPU_DEVICE_PROVER", "0")
        ref_srs = ref_marlin.universal_setup(*sizes, ref_marlin.generate_rand())
        ref_cs = ref_build()
        ref_pk, ref_vk = ref_marlin.index(ref_srs, ref_cs)
        expected = ref_serde.serialize_proof(ref_marlin.prove(ref_pk, ref_cs))

    srs = marlin.universal_setup(*sizes, marlin.generate_rand(), device=CPU)
    cs = build()
    pk, vk = marlin.index(srs, cs)
    assert serde.serialize_verifying_key(vk) == ref_serde.serialize_verifying_key(ref_vk)
    routes = {"native": lambda: marlin.prove(pk, cs)}
    if case == "small":
        def plain():
            with monkeypatch.context() as mp:
                mp.setenv("SWTPU_NATIVE", "0")
                return marlin.prove(pk, cs)
        routes["plain"] = plain
    for name, prove in routes.items():
        proof = prove()
        assert serde.serialize_proof(proof) == expected, name
    assert marlin.verify(vk, public, proof)
    kzg10._SRS_MEMO.clear()

"""The port's proof pipeline and block validation held against the JAX
package's, on the CPU: pipelined proofs byte for byte against the JAX host
prover, the abort on a stage's error, ``State.validate_block`` on the
reference test's block, the thread-safe shared state the pipeline's threads
rely on, and the CLI's proof-pipeline sequence.  Tolerance 0."""

import os
import sys
import threading
import time

import pytest
import torch

from simpleworks_tpu import marlin as ref_marlin
from simpleworks_tpu.examples import manual_constraints as ref_manual
from simpleworks_tpu.examples.simple_payments import ledger as ref_ledger
from simpleworks_tpu.examples.simple_payments import transaction as ref_transaction
from simpleworks_tpu.examples.simple_payments.account import AccountId as RefAccountId
from simpleworks_tpu.fields.bls12_377 import ConstraintF as RefF
from simpleworks_tpu.marlin import serialization as ref_serde
from simpleworks_tpu.r1cs.constraint_system import ONE as REF_ONE
from simpleworks_tpu.r1cs.constraint_system import ConstraintSystem as RefCS
from simpleworks_tpu.utils.rng import test_rng as ref_test_rng
from simpleworks_tpu_torch import marlin
from simpleworks_tpu_torch.examples import manual_constraints, run
from simpleworks_tpu_torch.examples.simple_payments import ledger, transaction
from simpleworks_tpu_torch.examples.simple_payments.account import AccountId
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
from simpleworks_tpu_torch.marlin import serialization as serde
from simpleworks_tpu_torch.ops import _build, ntt
from simpleworks_tpu_torch.parallel import proof_pipeline
from simpleworks_tpu_torch.r1cs.constraint_system import ONE, ConstraintSystem
from simpleworks_tpu_torch.utils.rng import test_rng

os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # more threads only contend with the other test workers


@pytest.fixture(autouse=True, scope="module")
def _no_disk_checkpoints():
    """The disk checkpoints off: every setup and index of this file is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_SRS_DISK_CACHE", "0")
        mp.setenv("SWTPU_PK_DISK_CACHE", "0")
        yield


CPU = torch.device("cpu")
SRS_SIZES = (100, 25, 300)  # the proof-pipeline workload's SRS
VALUES = [3, 5, 8, 13]


def square_add_chain(cs_cls, one, field, steps: int, x: int = 3):
    cs = cs_cls(field)
    a = cs.new_input_variable(x)
    cur_val = x
    cur = cs.new_witness_variable(cur_val)
    cs.enforce_constraint(cs.lc((1, a)) - cs.lc((1, cur)), cs.lc((1, one)), cs.lc())
    for _ in range(steps):
        nxt_val = (cur_val * cur_val + cur_val) % P
        nxt = cs.new_witness_variable(nxt_val)
        cs.enforce_constraint(cs.lc((1, cur)), cs.lc((1, cur)), cs.lc((1, nxt)) - cs.lc((1, cur)))
        cur, cur_val = nxt, nxt_val
    return cs


@pytest.fixture(scope="module")
def srs_pair():
    """Both packages' SRS(100, 25, 300) from ``generate_rand()``; the port's
    is its own setup's, which the proof-pipeline sequence's setup then reads
    from the SRS memo."""
    ref_srs = ref_marlin.universal_setup(*SRS_SIZES, ref_marlin.generate_rand())
    return ref_srs, marlin.universal_setup(*SRS_SIZES, marlin.generate_rand(), device=CPU)


@pytest.fixture
def reference_host_prover(monkeypatch):
    """The JAX package's host prover: its device twin off, no disk
    checkpoint."""
    monkeypatch.setenv("SWTPU_DEVICE_PROVER", "0")
    monkeypatch.setenv("SWTPU_PK_DISK_CACHE", "0")


def test_prove_stream_matches_reference(srs_pair, reference_host_prover):
    ref_srs, srs = srs_pair
    ref_pk, _ = ref_marlin.index(ref_srs, ref_manual.synthesize(3, 3))
    expected = [ref_serde.serialize_proof(ref_marlin.prove(ref_pk, ref_manual.synthesize(v, v),
                                                           ref_test_rng()))
                for v in VALUES]
    pk, vk = marlin.index(srs, manual_constraints.synthesize(3, 3))
    fns = [lambda v=v: manual_constraints.synthesize(v, v) for v in VALUES]
    proofs, stats = proof_pipeline.prove_stream(pk, fns, rng_factory=test_rng, with_stats=True)
    assert [serde.serialize_proof(p) for p in proofs] == expected
    assert stats.items == len(VALUES)
    assert stats.synth_busy_seconds > 0 and stats.prove_busy_seconds > 0
    assert stats.speedup > 0 and stats.overlap_seconds >= 0
    assert proof_pipeline.prove_stream(pk, []) == []


#: three shapes: 1, 3 and 6 constraints
CIRCUITS = [
    (lambda: manual_constraints.synthesize(7, 7), lambda: ref_manual.synthesize(7, 7)),
    (lambda: square_add_chain(ConstraintSystem, ONE, ConstraintF, 2),
     lambda: square_add_chain(RefCS, REF_ONE, RefF, 2)),
    (lambda: square_add_chain(ConstraintSystem, ONE, ConstraintF, 5),
     lambda: square_add_chain(RefCS, REF_ONE, RefF, 5)),
]


def test_prove_indexed_stream_matches_reference(srs_pair, reference_host_prover):
    """Three circuits of three shapes through one stream: each indexed, proved
    and verified, the bytes those of the JAX host prover's index and prove."""
    ref_srs, srs = srs_pair
    expected = []
    for _build_cs, ref_build in CIRCUITS:
        ref_cs = ref_build()
        ref_pk, _ = ref_marlin.index(ref_srs, ref_cs)
        expected.append(ref_serde.serialize_proof(ref_marlin.prove(ref_pk, ref_cs)))
    results = proof_pipeline.prove_indexed_stream(srs, [build() for build, _ in CIRCUITS],
                                                  max_in_flight=1)
    assert [ok for _, ok in results] == [True] * len(CIRCUITS)
    assert [serde.serialize_proof(p) for p, _ in results] == expected


def test_pipeline_error_aborts_and_is_raised():
    """A stage that raises stops the pipeline: the error reaches the caller,
    the later items are not worked on, and every thread has ended (the
    pipeline joins each with a bound, so a hang fails instead)."""
    seen = []

    def boom(x):
        if x == 2:
            raise RuntimeError("stage failed")
        return x

    before = {t.name for t in threading.enumerate()}
    with pytest.raises(RuntimeError, match="stage failed"):
        proof_pipeline.run_pipeline(range(50), [("ok", lambda x: seen.append(x) or x),
                                                ("boom", boom)], max_in_flight=1)
    assert len(seen) < 50
    time.sleep(2 * proof_pipeline._POLL_S)
    assert not {t.name for t in threading.enumerate() if t.name.startswith("proof-pipeline")} - \
        before
    results, stats = proof_pipeline.run_pipeline(range(5), [("a", lambda x: x + 1),
                                                            ("b", lambda x: 2 * x)])
    assert results == [2, 4, 6, 8, 10] and stats.items == 5


def make_block(led, txn, account_id, rng):
    """tests/test_parallel.py::test_ledger_validate_block_dp's ledger and
    block, from ``rng``: 8 accounts, two registered, account 1 holding 10;
    a transfer of 5, one signed with the other account's key, an overspend
    of 11 and a transfer to an unregistered account."""
    pp = led.Parameters.sample(rng, prove_transactions=False)
    state = led.State(8, pp)
    _, _apk, ask = state.sample_keys_and_register(pp, rng)
    _, _bpk, bsk = state.sample_keys_and_register(pp, rng)
    state.update_balance(account_id(1), 10)
    one, two, three = account_id(1), account_id(2), account_id(3)
    block = [txn.Transaction.create(pp, one, two, 5, ask, rng),
             txn.Transaction.create(pp, one, two, 5, bsk, rng),
             txn.Transaction.create(pp, one, two, 11, ask, rng),
             txn.Transaction.create(pp, one, three, 1, ask, rng)]
    return pp, state, block


def test_validate_block_matches_reference():
    ref_pp, ref_state, ref_block = make_block(ref_ledger, ref_transaction, RefAccountId,
                                              ref_test_rng())
    reference = [tx.validate(ref_pp, ref_state) for tx in ref_block]
    pp, state, block = make_block(ledger, transaction, AccountId, test_rng())
    root = state.root()
    verdicts = state.validate_block(pp, block, devices=["cpu"] * 2)
    assert verdicts == reference == [True, False, False, False]
    assert [tx.validate(pp, state) for tx in block] == verdicts
    assert state.root() == root and state.id_to_account_info[AccountId(1)].balance == 10


def test_shared_state_under_two_threads():
    """The exact-fp32 block counts the threads inside it: the setting is
    ``"ieee"`` while either thread is inside, and the caller's again once
    both have left, whichever leaves first; launch counts from many threads
    switching as often as they can all land."""
    matmul = torch.backends.cuda.matmul
    caller = matmul.fp32_precision
    first_in, second_in, first_out = threading.Event(), threading.Event(), threading.Event()
    seen = {}

    def first():
        with ntt._exact_fp32():
            first_in.set()
            second_in.wait(5)
        seen["after_first"] = matmul.fp32_precision
        first_out.set()

    def second():
        first_in.wait(5)
        with ntt._exact_fp32():
            second_in.set()
            first_out.wait(5)
            seen["second_alone"] = matmul.fp32_precision

    threads = [threading.Thread(target=first), threading.Thread(target=second)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10)
    assert not any(t.is_alive() for t in threads)
    assert seen == {"after_first": "ieee", "second_alone": "ieee"}
    assert matmul.fp32_precision == caller

    saved, interval = dict(_build.LAUNCHES), sys.getswitchinterval()
    try:
        _build.reset_launches()
        sys.setswitchinterval(1e-6)  # switch threads as often as the interpreter can
        workers = [threading.Thread(target=lambda: [_build.count_launch("mod_add")
                                                    for _ in range(5_000)])
                   for _ in range(16)]  # more threads than the machine has cores
        for t in workers:
            t.start()
        for t in workers:
            t.join(30)
        assert not any(t.is_alive() for t in workers)
        assert _build.LAUNCHES["mod_add"] == 16 * 5_000  # no increment lost
    finally:
        sys.setswitchinterval(interval)
        _build.LAUNCHES.update(saved)


def test_proof_pipeline_sequence_on_the_cpu(srs_pair):
    """The CLI's proof-pipeline workload at demo scale on the CPU (its setup
    the fixture's, from the SRS memo): every proof verifies (the sequence
    raises otherwise), and the stats count them."""
    steps = []
    out = run.proof_pipeline_sequence(lambda key, _label, fn: steps.append(key) or fn(),
                                      run.PIPELINE_VALUES[False], device=CPU)
    assert steps == ["setup_index", "pipeline", "verify"]
    assert run.PIPELINE_VALUES[False] == VALUES and run.PIPELINE_VALUES[True] == list(range(3, 11))
    assert out["stats"].items == len(VALUES) == len(out["proofs"])
    assert run.WORKLOADS["proof-pipeline"] is run.run_proof_pipeline

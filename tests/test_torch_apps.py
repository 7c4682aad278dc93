"""The port's application layer held against the JAX package's: ElGamal, the
field-element serde, the standard-form packers, the typed config, the
simple-payments ledger's serial path (without the per-transaction Marlin
leg), and the demo CLI's argument handling. Tolerance 0."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from simpleworks_tpu import config as ref_config
from simpleworks_tpu import elgamal as ref_elgamal
from simpleworks_tpu.curves.edwards import prime_subgroup_generator as ref_generator
from simpleworks_tpu.examples import run as ref_run
from simpleworks_tpu.examples.simple_payments import ledger as ref_ledger
from simpleworks_tpu.fields import pack as ref_pack
from simpleworks_tpu.fields import serialization as ref_serde
from simpleworks_tpu.fields.bls12_377 import ConstraintF as RefF
from simpleworks_tpu.fields.bls12_377 import Fq as RefFq
from simpleworks_tpu.utils.rng import test_rng as ref_test_rng
from simpleworks_tpu_torch import config, elgamal
from simpleworks_tpu_torch.curves.edwards import prime_subgroup_generator
from simpleworks_tpu_torch.examples import run
from simpleworks_tpu_torch.examples.simple_payments import ledger
from simpleworks_tpu_torch.examples.simple_payments.account import AccountId
from simpleworks_tpu_torch.fields import pack
from simpleworks_tpu_torch.fields import serialization as serde
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF, Fq
from simpleworks_tpu_torch.utils.rng import test_rng

os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # host arithmetic only: more threads only contend with the other workers


@pytest.fixture(autouse=True, scope="module")
def _no_disk_checkpoints():
    """The disk checkpoints off: every setup and index of this file is built."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("SWTPU_SRS_DISK_CACHE", "0")
        mp.setenv("SWTPU_PK_DISK_CACHE", "0")
        yield


def seeded_values(modulus: int, n: int, seed: int) -> list[int]:
    """n values below ``modulus`` from a seed, with 0, 1 and modulus - 1 first."""
    rng = np.random.default_rng(seed)
    nbytes = (modulus.bit_length() + 7) // 8 + 8
    return [0, 1, modulus - 1] + [int.from_bytes(rng.bytes(nbytes), "little") % modulus
                                  for _ in range(n - 3)]


def test_elgamal_matches_reference():
    def run_elgamal(mod, generator, rng):
        params = mod.setup(rng)
        pk, sk = mod.keygen(params, rng)
        message = generator().scalar_mul(7777)
        ct = mod.encrypt(params, pk, message, rng)
        _, other_sk = mod.keygen(params, rng)
        return [pk.to_affine(), sk, ct[0].to_affine(), ct[1].to_affine(),
                mod.decrypt(params, sk, ct) == message, mod.decrypt(params, other_sk, ct) == message]

    port = run_elgamal(elgamal, prime_subgroup_generator, test_rng())
    assert port == run_elgamal(ref_elgamal, ref_generator, ref_test_rng())
    assert port[-2:] == [True, False]


def test_field_serde_matches_reference():
    for value in seeded_values(ConstraintF.PARAMS.modulus, 20, 1):
        data = serde.serialize_field_element(value)
        assert data == ref_serde.serialize_field_element(value)
        assert data == serde.serialize_field_element(ConstraintF(value))
        assert serde.deserialize_field_element(data).value == \
            ref_serde.deserialize_field_element(data).value == value


@pytest.mark.parametrize("field, ref_field", [(ConstraintF, RefF), (Fq, RefFq)], ids=["fr", "fq"])
def test_pack_matches_reference(field, ref_field):
    values = seeded_values(field.PARAMS.modulus, 33, 2)
    arr, ref_arr = pack.pack_standard(values, field.PARAMS), ref_pack.pack_standard(values,
                                                                                    ref_field.PARAMS)
    assert arr.dtype == ref_arr.dtype == np.uint32
    assert arr.shape == ref_arr.shape == (33, field.PARAMS.repr_bits // 16)
    assert np.array_equal(arr, ref_arr)
    assert pack.unpack_standard(arr, field.PARAMS) == \
        ref_pack.unpack_standard(ref_arr, ref_field.PARAMS) == values


def test_config_matches_reference():
    assert dataclasses.asdict(config.DEFAULT_CONFIG) == dataclasses.asdict(ref_config.DEFAULT_CONFIG)
    assert config.DEFAULT_CONFIG.large_srs == (100_000, 25_000, 300_000)


def test_payments_sequence_matches_reference():
    """The demo CLI's simple-payments sequence without the Marlin leg, as
    chip_smoke.py's payments path runs it, on the CPU: no pipeline at any
    step, and verdicts, balances and roots equal to the JAX package's, run
    now and kept in the workload fixture (the path checks the fixture itself
    and raises on a mismatch)."""
    import json

    import chip_smoke
    from test_torch_merkle_fixture import FIXTURE, reference_payments

    fixture = json.loads(FIXTURE.read_text())["payments"]
    port = chip_smoke.run_payments(torch.device("cpu"), reference=fixture,
                                   prove_transactions=False)
    ref = reference_payments()
    assert port["reference_equal"]
    assert port["pipelines"] == dict.fromkeys(chip_smoke.PAYMENTS_PIPELINES, 0)
    assert (port["verdicts"], port["balances"], port["roots"]) == \
        (ref["verdicts"], ref["balances"], ref["roots"])


def test_ledger_registration_matches_reference():
    """Registration up to a small ledger's capacity, balance updates and an
    unknown account, on both packages: equal ids, roots and refusals."""
    def register_all(mod, rng):
        pp = mod.Parameters.sample(rng, prove_transactions=False)
        state = mod.State(8, pp)  # height 3: 4 leaves, ids 1-3
        out = [state.root()]
        for balance in range(5):
            got = state.sample_keys_and_register(pp, rng)
            out.append(None if got is None else (got[0].value, got[1].to_affine(), state.root()))
            if got is not None:
                out.append(state.update_balance(got[0], balance * 11))
        out.append(state.update_balance(mod.AccountId(9), 1))
        return out + [state.root()]

    port = register_all(ledger, test_rng())
    assert port == register_all(ref_ledger, ref_test_rng())
    assert [r[0] for r in port[1:-2] if isinstance(r, tuple)] == [1, 2, 3]
    assert port[-3:-1] == [None, None]  # a full ledger refuses, an unknown id is not updated
    assert ledger.State(8, ledger.Parameters.sample(test_rng(), prove_transactions=False)) \
        .next_available_account == AccountId(1)


def test_run_rejects_unknown_workload_as_reference(capsys):
    for main in (run.main, ref_run.main):
        with pytest.raises(SystemExit) as exit_info:
            main(["bogus"])
        assert exit_info.value.code == 2
        assert "error: unknown workload 'bogus'" in capsys.readouterr().err


def test_run_raises_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run.main(["--full", "merkle-tree"])


# ------------------------------------------------------- observability ----


def build_namespaced(cs_cls, one, field):
    """tests/test_apps.py::test_constraint_accounting's circuit, plus an
    unattributed constraint."""
    cs = cs_cls(field)
    with cs.namespace("layer_a"):
        v = cs.new_witness_variable(1)
        cs.enforce_constraint(cs.lc((1, v)), cs.lc((1, one)), cs.lc((1, v)))
        with cs.namespace("inner"):
            cs.enforce_constraint(cs.lc((1, v)), cs.lc((1, one)), cs.lc((1, v)))
    with cs.namespace("layer_b"):
        cs.enforce_constraint(cs.lc((1, v)), cs.lc((1, one)), cs.lc((1, v)))
    cs.enforce_constraint(cs.lc((1, v)), cs.lc((1, one)), cs.lc((1, v)))
    return cs


def test_observability_matches_reference(monkeypatch, capsys, tmp_path):
    """The constraint accounting and the circuit summary give the
    reference's strings; the timer's report is the reference's format; the
    trace switch prints it; the profiler context writes a trace."""
    from simpleworks_tpu.r1cs.constraint_system import ONE as REF_ONE
    from simpleworks_tpu.r1cs.constraint_system import ConstraintSystem as RefCS
    from simpleworks_tpu.utils import observability as ref_obs
    from simpleworks_tpu_torch.r1cs.constraint_system import ONE, ConstraintSystem
    from simpleworks_tpu_torch.utils import observability as obs

    cs, ref_cs = build_namespaced(ConstraintSystem, ONE, ConstraintF), build_namespaced(
        RefCS, REF_ONE, RefF)
    counts = obs.constraint_counts_by_namespace(cs)
    assert counts == ref_obs.constraint_counts_by_namespace(ref_cs) == {
        "layer_a": 1, "layer_a/inner": 1, "layer_b": 1, "<root>": 1}
    assert obs.summarize_circuit(cs) == ref_obs.summarize_circuit(ref_cs)
    assert "constraints: 4" in obs.summarize_circuit(cs)

    timer, ref_timer = obs.KernelTimer(), ref_obs.KernelTimer()
    for t in (timer, ref_timer):
        for label in ("a", "b", "a"):
            with t.region(label):
                pass
        t.totals.update({"a": 0.5, "b": 1.25})  # fixed seconds: the strings compare
    assert timer.report() == ref_timer.report() == "b: 1.250s over 1 calls\na: 0.500s over 2 calls"
    timer.reset()
    assert timer.report() == "" and timer.counts == {}

    monkeypatch.setattr(obs, "PROVER_TIMER", ref_timer)
    monkeypatch.delenv("SWTPU_TRACE", raising=False)
    obs.maybe_report_prover("quiet")
    assert capsys.readouterr().err == ""
    monkeypatch.setenv("SWTPU_TRACE", "1")
    obs.maybe_report_prover("prove")
    assert capsys.readouterr().err == f"[trace] prove\n{ref_timer.report()}\n"

    monkeypatch.delenv("SWTPU_TORCH_PROFILE", raising=False)
    with obs.maybe_profile("off") as prof:
        assert prof is None
    monkeypatch.setenv("SWTPU_TORCH_PROFILE", str(tmp_path))
    with obs.maybe_profile("on") as prof:
        torch.ones(4).add_(1)
    assert prof is not None and (tmp_path / "on" / "trace.json").stat().st_size > 0

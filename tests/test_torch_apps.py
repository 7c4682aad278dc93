"""The port's application layer held against the JAX package's: ElGamal, the
field-element serde, the standard-form packers, the typed config, the
simple-payments ledger's serial path (without the per-transaction Marlin
leg), and the demo CLI's argument handling. Tolerance 0."""

import dataclasses

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

torch.set_num_threads(1)  # host arithmetic only: more threads only contend with the other workers


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

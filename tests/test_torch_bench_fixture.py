"""The reference bytes of the bench's schnorr-verify prove, kept in
tests/torch_fixtures/schnorr_bench_reference.json: the JAX package's host
prover on the draw sequence of bench.py bench_marlin_prove (test_rng(),
setup, keygen, sign(b"a message to sign"), then
universal_setup(100_000, 25_000, 300_000, generate_rand()), index, prove).
chip_smoke.py holds the card's verifying key and proof against them.

Regenerate the file (about two minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/test_torch_bench_fixture.py --write

and check it against a fresh reference prove with
``pytest -m "slow and fullscale" tests/test_torch_bench_fixture.py``.
"""

import hashlib
import json
import os
import pathlib
import sys

import pytest

FIXTURE = pathlib.Path(__file__).parent / "torch_fixtures" / "schnorr_bench_reference.json"
MESSAGE = b"a message to sign"
SRS_SIZES = (100_000, 25_000, 300_000)
#: the serialized proof of a Marlin prove with no public input
PROOF_BYTES = 1431


def reference_bytes() -> dict:
    """The reference's verifying-key and proof bytes of the bench prove,
    with their sha256, as the fixture file holds them.  Run with
    SWTPU_DEVICE_PROVER=0 and SWTPU_PK_DISK_CACHE=0: the host prover, and
    no proving key read from disk."""
    from simpleworks_tpu import marlin
    from simpleworks_tpu.examples.schnorr_circuit import synthesize
    from simpleworks_tpu.marlin.serialization import serialize_proof, serialize_verifying_key
    from simpleworks_tpu.schnorr import schnorr
    from simpleworks_tpu.utils.rng import test_rng

    rng = test_rng()
    params = schnorr.setup(rng)
    pk_s, sk = schnorr.keygen(params, rng)
    cs = synthesize(params, pk_s, MESSAGE, schnorr.sign(params, sk, MESSAGE, rng))
    srs = marlin.universal_setup(*SRS_SIZES, marlin.generate_rand())
    pk, vk = marlin.index(srs, cs)
    proof = marlin.prove(pk, cs)
    if not marlin.verify(vk, [], proof):
        raise AssertionError("the reference's bench proof does not verify")
    out = {"srs_sizes": list(SRS_SIZES), "message": MESSAGE.decode(),
           "num_constraints": cs.num_constraints}
    for key, data in (("verifying_key", serialize_verifying_key(vk)),
                      ("proof", serialize_proof(proof))):
        out[key] = {"bytes": len(data), "sha256": hashlib.sha256(data).hexdigest(),
                    "hex": data.hex()}
    return out


def test_fixture_is_well_formed():
    ref = json.loads(FIXTURE.read_text())
    assert tuple(ref["srs_sizes"]) == SRS_SIZES and ref["message"] == MESSAGE.decode()
    assert ref["num_constraints"] == 77_012
    for key in ("verifying_key", "proof"):
        data = bytes.fromhex(ref[key]["hex"])
        assert len(data) == ref[key]["bytes"]
        assert hashlib.sha256(data).hexdigest() == ref[key]["sha256"]
    assert ref["proof"]["bytes"] == PROOF_BYTES


@pytest.mark.slow
@pytest.mark.fullscale
def test_fixture_matches_reference_prove(monkeypatch):
    monkeypatch.setenv("SWTPU_DEVICE_PROVER", "0")
    monkeypatch.setenv("SWTPU_PK_DISK_CACHE", "0")
    assert reference_bytes() == json.loads(FIXTURE.read_text())


if __name__ == "__main__":
    if sys.argv[1:] != ["--write"]:
        sys.exit("usage: python tests/test_torch_bench_fixture.py --write")
    sys.path.insert(0, str(FIXTURE.parents[2]))  # the repo root, for simpleworks_tpu
    os.environ.update(SWTPU_DEVICE_PROVER="0", SWTPU_PK_DISK_CACHE="0")
    FIXTURE.parent.mkdir(exist_ok=True)
    FIXTURE.write_text(json.dumps(reference_bytes(), indent=1) + "\n")
    print(f"wrote {FIXTURE}")

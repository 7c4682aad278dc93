"""The port's Poseidon and Pedersen (simpleworks_tpu_torch.hash) held against
the JAX package's: equal parameters, equal native outputs on seed-made inputs,
and gadgets equal to native with constraint systems equal term for term to
the reference gadgets'. Tolerance 0: field values and bytes exact."""

import os

import numpy as np
import pytest
import torch

from simpleworks_tpu.curves import edwards as ref_edwards
from simpleworks_tpu.fields.bls12_377 import ConstraintF as RefF
from simpleworks_tpu.gadgets import boolean as ref_boolean
from simpleworks_tpu.gadgets import field_var as ref_field_var
from simpleworks_tpu.gadgets import uint as ref_uint
from simpleworks_tpu.hash import pedersen as ref_pedersen
from simpleworks_tpu.hash import pedersen_gadget as ref_pedersen_gadget
from simpleworks_tpu.hash import poseidon as ref_poseidon
from simpleworks_tpu.r1cs.constraint_system import ConstraintSystem as RefCS
from simpleworks_tpu.utils.rng import test_rng as ref_test_rng
from simpleworks_tpu_torch.curves import edwards
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.bls12_377 import ConstraintF
from simpleworks_tpu_torch.gadgets import boolean, field_var, uint
from simpleworks_tpu_torch.hash import pedersen, pedersen_gadget, poseidon
from simpleworks_tpu_torch.r1cs.constraint_system import ConstraintSystem
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


#: each package's modules, under one set of names
PACKAGES = {
    "port": dict(poseidon=poseidon, pedersen=pedersen, pedersen_gadget=pedersen_gadget,
                 edwards=edwards, boolean=boolean, field_var=field_var, uint=uint,
                 cs=lambda: ConstraintSystem(ConstraintF), rng=test_rng),
    "reference": dict(poseidon=ref_poseidon, pedersen=ref_pedersen,
                      pedersen_gadget=ref_pedersen_gadget, edwards=ref_edwards,
                      boolean=ref_boolean, field_var=ref_field_var, uint=ref_uint,
                      cs=lambda: RefCS(RefF), rng=ref_test_rng),
}
#: byte lengths around the sponge's rate: empty, one element, a full rate of
#: 31-byte chunks, one past it, several permutations
BYTE_LENGTHS = [0, 1, 30, 31, 62, 63, 200]
#: a 2-byte window (window size 4, 4 windows)
SMALL_WINDOW = (4, 4)


def both(fn):
    """``fn(pkg)`` for the port and the reference."""
    return fn(PACKAGES["port"]), fn(PACKAGES["reference"])


def seeded_bytes(n: int, seed: int) -> bytes:
    return np.random.default_rng(seed).bytes(n)


def assert_same_system(cs, ref_cs):
    assert cs.num_constraints == ref_cs.num_constraints > 0
    assert cs.to_matrices() == ref_cs.to_matrices()
    assert cs.full_assignment() == ref_cs.full_assignment()
    assert cs.is_satisfied() and ref_cs.is_satisfied()


# ------------------------------------------------------------ Poseidon ----


def test_poseidon_parameters_match_reference():
    port, ref = both(lambda g: g["poseidon"].poseidon_parameters())
    assert port == ref
    assert (port["alpha"], port["full_rounds"], port["partial_rounds"]) == (17, 8, 29)


@pytest.mark.parametrize("length", BYTE_LENGTHS)
def test_poseidon_native_matches_reference(length):
    data = seeded_bytes(length, length)
    port, ref = both(lambda g: g["poseidon"].poseidon2_hash(data))
    assert port == ref and 0 <= port < P


def test_poseidon_sponge_duplex_matches_reference():
    """Absorb, squeeze several, absorb again, squeeze: every mode change."""
    elems = [int.from_bytes(seeded_bytes(32, i), "little") % P for i in range(5)]

    def run(g):
        sponge = g["poseidon"].PoseidonSponge()
        sponge.absorb_elements(elems[:3])
        out = sponge.squeeze_elements(4)
        sponge.absorb_elements(elems[3:])
        return out + sponge.squeeze_elements(3) + sponge.squeeze_elements(1)

    port, ref = both(run)
    assert port == ref and len(set(port)) == len(port)


def test_poseidon_hash_any_matches_reference():
    def run(g):
        point = g["edwards"].prime_subgroup_generator().scalar_mul(12345)
        return g["poseidon"].poseidon2_hash_any(
            42, P + 7, True, seeded_bytes(45, 1), point, [1, (2, b"xy")], bytearray(b"z"))

    port, ref = both(run)
    assert port == ref
    assert poseidon.poseidon2_hash_any(b"abc") == ref_poseidon.poseidon2_hash(b"abc")


def test_poseidon_gadget_matches_native_and_reference():
    data = seeded_bytes(40, 2)  # two 31-byte chunks

    def run(g):
        cs = g["cs"]()
        bytes_var = g["uint"].UIntGadget.new_input_vec(cs, data)
        out = g["poseidon"].poseidon2_hash_gadget(bytes_var)
        return cs, out.value()

    (cs, value), (ref_cs, ref_value) = both(run)
    assert value == ref_value == poseidon.poseidon2_hash(data)
    assert_same_system(cs, ref_cs)


def test_poseidon_any_gadget_matches_native_and_reference():
    data = seeded_bytes(33, 3)

    def run(g):
        cs = g["cs"]()
        fv = g["field_var"].FieldVar.new_witness(cs, 77)
        flag = g["boolean"].Boolean.new_witness(cs, True)
        bytes_var = [g["uint"].UIntGadget.new_witness(cs, 8, b) for b in data]
        out = g["poseidon"].poseidon2_hash_any_gadget(cs, fv, flag, bytes_var, [fv])
        return cs, out.value()

    (cs, value), (ref_cs, ref_value) = both(run)
    assert value == ref_value == poseidon.poseidon2_hash_any(77, True, data, [77])
    assert_same_system(cs, ref_cs)


# ------------------------------------------------------------ Pedersen ----


def generator_coords(params):
    return [[pt.to_affine() for pt in powers] for powers in params.generators]


@pytest.mark.parametrize("window", [(4, 4), (4, 144)], ids=["small", "leaf"])
def test_pedersen_generators_match_reference(window):
    size, count = window
    port, ref = both(lambda g: g["pedersen"].pedersen_setup(
        g["pedersen"].PedersenWindow(size, count), g["rng"]()))
    assert generator_coords(port) == generator_coords(ref)
    assert len(port.generators) == count and all(len(w) == size for w in port.generators)


def test_pedersen_evaluate_matches_reference():
    left, right = seeded_bytes(32, 4), seeded_bytes(32, 5)

    def run(g):
        ped = g["pedersen"]
        leaf = ped.pedersen_setup(ped.LEAF_WINDOW, g["rng"]())
        two = ped.pedersen_setup(ped.TWO_TO_ONE_WINDOW, g["rng"]())
        return [ped.pedersen_evaluate(leaf, b""), ped.pedersen_evaluate(leaf, seeded_bytes(72, 6)),
                ped.pedersen_evaluate(two, left + right),
                ped.pedersen_evaluate_two_to_one(two, left, right),
                ped.pedersen_evaluate_point(leaf, b"\x01").to_affine(),
                ped.pedersen_hash(b"hello")]

    port, ref = both(run)
    assert port == ref
    assert port[2] == port[3]


def test_pedersen_capacity_error_matches_reference():
    def run(g):
        ped = g["pedersen"]
        params = ped.pedersen_setup(ped.PedersenWindow(*SMALL_WINDOW), g["rng"]())
        ped.pedersen_evaluate(params, bytes(2))  # at capacity: fine
        with pytest.raises(ValueError, match="exceeds Pedersen window capacity") as err:
            ped.pedersen_evaluate(params, bytes(3))
        return str(err.value)

    port, ref = both(run)
    assert port == ref


def test_pedersen_gadget_matches_native_and_reference():
    data = seeded_bytes(2, 7)

    def run(g):
        params = g["pedersen"].pedersen_setup(g["pedersen"].PedersenWindow(*SMALL_WINDOW), g["rng"]())
        cs = g["cs"]()
        bytes_var = [g["uint"].UIntGadget.new_witness(cs, 8, b) for b in data]
        out = g["pedersen_gadget"].pedersen_evaluate_gadget(cs, params, bytes_var)
        return cs, out.value(), g["pedersen"].pedersen_evaluate(params, data)

    (cs, value, native), (ref_cs, ref_value, ref_native) = both(run)
    assert value == native == ref_value == ref_native
    assert_same_system(cs, ref_cs)


def test_parameters_from_reference_round_trips():
    window = pedersen.PedersenWindow(*SMALL_WINDOW)
    ref_params = ref_pedersen.pedersen_setup(ref_pedersen.PedersenWindow(*SMALL_WINDOW), ref_test_rng())
    coords = generator_coords(ref_params)
    params = pedersen.parameters_from_reference(window, coords)
    assert params.window == window
    assert generator_coords(params) == coords
    assert generator_coords(pedersen.pedersen_setup(window, test_rng())) == coords
    data = seeded_bytes(2, 8)
    assert pedersen.pedersen_evaluate(params, data) == ref_pedersen.pedersen_evaluate(ref_params, data)
    with pytest.raises(ValueError, match="windows"):
        pedersen.parameters_from_reference(window, coords[:-1])
    bad = [list(w) for w in coords]
    bad[0][0] = (bad[0][0][0], bad[0][0][1] + 1)
    with pytest.raises(ValueError, match="not on the curve"):
        pedersen.parameters_from_reference(window, bad)

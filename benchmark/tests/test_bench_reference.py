"""The plain reference against the program on the CPU, at small sizes: the
field's constants, G1, a commitment, the SRS, and a Marlin index and proof."""

import numpy as np
import torch

from benchmark.lib import seeds
from benchmark.reference import field, g1, kzg, marlin as ref

from simpleworks_tpu_torch.curves.bls12_377 import G1Point
from simpleworks_tpu_torch.fields import bls12_377 as prog_field
from simpleworks_tpu_torch.fields.bls12_377 import Fr


def jac(p):
    return (p.X, p.Y, p.Z)


def test_field_constants():
    assert field.R == prog_field.FR_MODULUS and field.Q == prog_field.FQ_MODULUS
    for log_n in (0, 1, 5, 17, 18):
        assert field.root_of_unity(1 << log_n) == (prog_field.fr_root_of_unity(1 << log_n)
                                                    if log_n else 1)


def test_sampling_matches_the_program():
    a, b = seeds.WordStream(7, "x"), seeds.WordStream(7, "x")
    assert [field.sample_fr(a.next_u64) for _ in range(20)] == [Fr.rand(b).value for _ in range(20)]


def test_g1_matches_the_program():
    gen = G1Point.generator()
    for k in (0, 1, 2, 15, 16, 2**200 + 12345, field.R - 1, field.R):
        assert g1.equal(g1.mul(k, g1.GENERATOR), jac(gen.scalar_mul(k)))
        assert g1.compress(g1.mul(k, g1.GENERATOR)) == gen.scalar_mul(k).serialize_compressed()
    p, q = g1.mul(5, g1.GENERATOR), g1.mul(7, g1.GENERATOR)
    assert g1.equal(g1.add(p, q), g1.mul(12, g1.GENERATOR))
    assert g1.equal(g1.add(p, p), g1.double(p))
    assert g1.add(p, g1.neg(p))[2] == 0


def test_commitment_and_srs_match_the_program():
    from simpleworks_tpu_torch.kzg import kzg10

    srs = kzg10.setup(127, seeds.WordStream(3, "srs"), device="cpu")
    tau, _ = kzg.setup_scalars(seeds.WordStream(3, "srs").next_u64)
    for i in (0, 1, 77, 127):
        assert g1.equal(jac(srs.power(i)), kzg.srs_power(tau, i))
    rng = np.random.default_rng(5)
    limbs = rng.integers(0, 1 << 16, size=(16, 100), dtype=np.int32)
    limbs[15] %= field.R >> 240
    got = kzg10.commit(srs, torch.from_numpy(limbs)).comm
    assert g1.equal(jac(got), kzg.commitment(limbs, kzg.power_limbs(tau, 100)))
    wrong = limbs.copy()
    wrong[3, 50] ^= 1
    assert not g1.equal(jac(got), kzg.commitment(wrong, kzg.power_limbs(tau, 100)))


def test_mont_eval_blocks_agree(monkeypatch):
    rng = np.random.default_rng(9)
    limbs = rng.integers(0, 1 << 16, size=(16, 70), dtype=np.int64)
    x_limbs = kzg.power_limbs(123456789, 70)
    whole = kzg.mont_eval(limbs, x_limbs)
    monkeypatch.setattr(kzg, "BLOCK", 16)
    assert kzg.mont_eval(limbs, x_limbs) == whole
    values = [sum(int(limbs[j, i]) << (16 * j) for j in range(16)) for i in range(70)]
    direct = sum(v * pow(123456789, i, field.R) for i, v in enumerate(values))
    assert whole == direct % field.R * field.MONT_R_INV % field.R


def _proof_dict(proof):
    def pair(c):
        return (jac(c.comm), None if c.shifted_comm is None else jac(c.shifted_comm))

    return {"commitments": {n: pair(c) for n, c in proof.commitments.items()},
            "evaluations": dict(proof.evaluations),
            "pc_proof_beta": jac(proof.pc_proof_beta), "pc_proof_gamma": jac(proof.pc_proof_gamma),
            "pc_rand_beta": proof.pc_rand_beta, "pc_rand_gamma": proof.pc_rand_gamma}


def test_marlin_index_and_verifier_match_the_program():
    import chip_smoke
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.utils.rng import chacha12_rng

    cs = chip_smoke.square_add_chain(20)  # one public input
    sizes = (64, 64, 128)
    srs = marlin.universal_setup(*sizes, seeds.WordStream(11, "srs"), device="cpu")
    tau, gamma = kzg.setup_scalars(seeds.WordStream(11, "srs").next_u64)
    pk, vk = marlin.index(srs, cs)
    proof = marlin.prove(pk, cs, chacha12_rng(bytes(32)))
    matrices = cs.to_matrices()
    info = ref.index_info(matrices, cs.num_instance_variables, cs.num_witness_variables,
                          cs.num_constraints)
    points = ref.index_points(ref.index_scalars(matrices, info, tau))
    for name in ref.INDEX_POLYS:
        assert g1.equal(points[name], jac(vk.index_commitments[name].comm)), name
    degree = ref.max_degree_for(*sizes)
    assert degree == srs.max_degree
    instance = list(cs.instance_assignment)
    assert instance == [1, 3]
    good = _proof_dict(proof)
    assert ref.verify(info, points, good, tau, gamma, degree, instance)
    assert not ref.verify(info, points, good, tau, gamma, degree, [1, 4])
    for name in ("w", "g_2", "row_a"):
        bad = _proof_dict(proof)
        bad["evaluations"][name] = (bad["evaluations"][name] + 1) % field.R
        assert not ref.verify(info, points, bad, tau, gamma, degree, instance), name
    for name in ("mask", "g_1"):
        bad = _proof_dict(proof)
        point, shifted = bad["commitments"][name]
        bad["commitments"][name] = (g1.add(point, g1.GENERATOR), shifted)
        assert not ref.verify(info, points, bad, tau, gamma, degree, instance), name
    bad = _proof_dict(proof)
    bad["pc_proof_gamma"] = g1.double(bad["pc_proof_gamma"])
    assert not ref.verify(info, points, bad, tau, gamma, degree, instance)
    bad = _proof_dict(proof)
    bad["pc_rand_beta"] += 1
    assert not ref.verify(info, points, bad, tau, gamma, degree, instance)

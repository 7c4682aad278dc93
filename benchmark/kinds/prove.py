"""Kind ``prove``: ``marlin.prove(pk, cs, rng)`` on the next of a pool of
``pool`` circuits, each request with a fresh zero-knowledge rng from the
seed.  The circuits come from the ``.py`` file beside the configuration's
``.json`` (its ``build(seed, count, config)``); the SRS and the index are
made once in set-up.

``correct``: the verifying key's points against the plain reference's index
(Lagrange evaluations at τ, which the seed gives), and every proof of the
window through the reference's verifier over that index."""

from __future__ import annotations

from benchmark.lib import seeds
from benchmark.lib.generator import Traffic, jacobian, load_module


class Kind(Traffic):
    def setup(self) -> None:
        from simpleworks_tpu_torch import marlin

        self.mark("program import")
        inputs = load_module(self.root / self.config["_file"].replace(".json", ".py"),
                             f"bench_config_{self.config['name'].replace('-', '_')}")
        self.pool = inputs.build(self.seed, int(self.mix["pool"]), self.config)
        self.mark("synthesis")
        self.srs = marlin.universal_setup(*self.config["srs"], seeds.WordStream(self.seed, "srs"),
                                          device=self.device)
        self.mark("srs")
        self.pk, self.vk = marlin.index(self.srs, self.pool[0])
        sizes = (self.vk.info.domain_h_size, self.vk.info.domain_k_size)
        if sizes != (self.config["domain_h"], self.config["domain_k"]):
            raise ValueError(f"the circuit's domains {sizes} differ from the configuration's")
        self.mark("index")

    def _rng(self, tag: str):
        from simpleworks_tpu_torch.utils.rng import chacha12_rng

        return chacha12_rng(seeds.seed_bytes(self.seed, tag))

    def warm(self) -> None:
        from simpleworks_tpu_torch import marlin

        marlin.prove(self.pk, self.pool[0], self._rng("zk-warm"))

    def request(self, i: int):
        from simpleworks_tpu_torch import marlin

        return marlin.prove(self.pk, self.pool[i % len(self.pool)], self._rng(f"zk{i}"))

    def record(self, i: int, proof):
        def pair(c):
            shifted = c.shifted_comm
            return (jacobian(c.comm), None if shifted is None else jacobian(shifted))

        return (i % len(self.pool), {
            "commitments": {name: pair(c) for name, c in proof.commitments.items()},
            "evaluations": dict(proof.evaluations),
            "pc_proof_beta": jacobian(proof.pc_proof_beta),
            "pc_proof_gamma": jacobian(proof.pc_proof_gamma),
            "pc_rand_beta": proof.pc_rand_beta, "pc_rand_gamma": proof.pc_rand_gamma})

    def vk_points(self) -> dict:
        vk = self.vk
        points = {name: jacobian(c.comm) for name, c in vk.index_commitments.items()}
        points["g"] = jacobian(vk.g)
        points["gamma_g"] = jacobian(vk.gamma_g)
        for bound, p in vk.shift_powers.items():
            points[f"shift_{bound}"] = jacobian(p)
        return points

    def check(self, records: list) -> dict:
        from benchmark.reference import g1, kzg, marlin as ref

        vk_points = self.vk_points()
        self.srs = self.pk = self.vk = None  # the program's state, before the reference
        cs0 = self.pool[0]
        tau, gamma = kzg.setup_scalars(seeds.WordStream(self.seed, "srs").next_u64)
        max_degree = ref.max_degree_for(*self.config["srs"])
        matrices = cs0.to_matrices()
        info = ref.index_info(matrices, cs0.num_instance_variables,
                              cs0.num_witness_variables, cs0.num_constraints)
        points = ref.index_points(ref.index_scalars(matrices, info, tau))
        expected = dict(points)
        expected["g"] = g1.GENERATOR
        expected["gamma_g"] = g1.mul(gamma, g1.GENERATOR)
        for bound in sorted({info.n - 2, info.m - 2}):
            expected[f"shift_{bound}"] = kzg.srs_power(tau, max_degree - bound)
        vk_bad = sum(name not in vk_points or not g1.equal(vk_points[name], point)
                     for name, point in expected.items())
        vk_bad += len(set(vk_points) - set(expected))
        rejected = sum(not ref.verify(info, points, proof, tau, gamma, max_degree,
                                      list(self.pool[k].instance_assignment))
                       for k, proof in records)
        return {"vk_mismatches": (vk_bad, 0), "proofs_rejected": (rejected, 0),
                "_compared": {"vk_points": len(expected), "proofs": len(records)}}

"""Child process of the port's two-process prover test
(tests/test_torch_multihost.py::test_prove_bytes_two_processes), the twin of
tests/multihost_child.py: each child joins a two-process torch.distributed
job (gloo), shards the prover's transforms and commits over the global list
of 2 ranks × 4 CPU devices through ops.accel, and prints the proof's bytes
for the parent to hold against the single-process prove.

    python tests/torch_multihost_child.py <init_method> <rank>
"""

import os
import sys

os.environ["SWTPU_THREADS"] = "1"
os.environ["SWTPU_SRS_DISK_CACHE"] = "0"
os.environ["SWTPU_PK_DISK_CACHE"] = "0"

CHAIN_STEPS = 120
SRS_SIZES = (128, 128, 128)
LOCAL_DEVICES = ["cpu"] * 4


def square_chain(n_constraints: int, x: int = 3):
    from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS, ConstraintF
    from simpleworks_tpu_torch.r1cs.constraint_system import ONE, ConstraintSystem

    cs = ConstraintSystem(ConstraintF)
    a = cs.new_input_variable(x)
    cur, cur_val = cs.new_witness_variable(x), x
    cs.enforce_constraint(cs.lc((1, a)) - cs.lc((1, cur)), cs.lc((1, ONE)), cs.lc())
    for _ in range(n_constraints):
        nxt_val = cur_val * cur_val % FR_MODULUS
        nxt = cs.new_witness_variable(nxt_val)
        cs.enforce_constraint(cs.lc((1, cur)), cs.lc((1, cur)), cs.lc((1, nxt)))
        cur, cur_val = nxt, nxt_val
    return cs, x


def main() -> None:
    init_method, rank = sys.argv[1], int(sys.argv[2])
    import torch

    torch.set_num_threads(1)
    from simpleworks_tpu_torch import marlin
    from simpleworks_tpu_torch.marlin.serialization import serialize_proof
    from simpleworks_tpu_torch.ops import accel
    from simpleworks_tpu_torch.parallel import msm_sharded, multihost, ntt_sharded

    multihost.initialize(init_method, world_size=2, rank=rank, timeout_s=300)
    try:
        cs, x = square_chain(CHAIN_STEPS)
        srs = marlin.universal_setup(*SRS_SIZES, marlin.generate_rand(), device="cpu")
        pk, vk = marlin.index(srs, cs)
        calls = {"ntt": 0, "msm": 0}

        def counted(key, fn):
            def wrapper(*args, **kwargs):
                calls[key] += 1
                return fn(*args, **kwargs)
            return wrapper

        ntt_sharded.sharded_transform = counted("ntt", ntt_sharded.sharded_transform)
        msm_sharded.sharded_msm_native = counted("msm", msm_sharded.sharded_msm_native)
        msm_sharded.sharded_msm = counted("msm", msm_sharded.sharded_msm)
        # only the largest transforms (4n and up) and commits (3n and up)
        # shard, as in the reference child
        h_size = pk.index.info.domain_h_size
        accel.SHARDED_NTT_THRESHOLD = 4 * h_size
        accel.SHARDED_MSM_THRESHOLD = 3 * h_size
        accel.set_prover_devices(LOCAL_DEVICES)
        try:
            assert len(accel.prover_devices()) == 2 * len(LOCAL_DEVICES)
            proof = marlin.prove(pk, cs)
        finally:
            accel.set_prover_devices(None)
        assert calls["ntt"] > 0 and calls["msm"] > 0, f"sharded routes not taken: {calls}"
        assert marlin.verify(vk, [x], proof)
        print("PROOF_HEX:" + serialize_proof(proof).hex(), flush=True)
    finally:
        multihost.shutdown()


if __name__ == "__main__":
    main()

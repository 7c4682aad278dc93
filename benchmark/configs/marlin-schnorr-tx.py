"""The inputs of the marlin-schnorr-tx configuration: a pool of Schnorr-verify
transaction circuits, synthesised through the port's circuit code."""

from __future__ import annotations

from benchmark.lib import seeds


def build(seed: int, count: int, config: dict) -> list:
    """``count`` constraint systems, each over its own key pair, message and
    signature drawn from ``seed``; the Schnorr parameters are the upstream
    examples' (ark_std::test_rng()), so every circuit has the same matrices."""
    from simpleworks_tpu_torch.examples.schnorr_circuit import synthesize
    from simpleworks_tpu_torch.schnorr import schnorr
    from simpleworks_tpu_torch.utils.rng import chacha12_rng, test_rng

    params = schnorr.setup(test_rng())
    pool = []
    for j in range(count):
        rng = chacha12_rng(seeds.seed_bytes(seed, f"tx{j}"))
        public_key, secret_key = schnorr.keygen(params, rng)
        message = rng.fill_bytes(int(config["message_bytes"]))
        signature = schnorr.sign(params, secret_key, message, rng)
        pool.append(synthesize(params, public_key, message, signature))
    return pool

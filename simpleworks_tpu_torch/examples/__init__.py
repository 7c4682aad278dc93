"""Reference workloads on the port.

* :mod:`.manual_constraints` — raw R1CS equality circuit
* :mod:`.test_circuit` — two UInt8 witnesses constrained equal
* :mod:`.schnorr_circuit` — the schnorr-verify circuit of the bench prove
* :mod:`.merkle_tree` — the 8-leaf Pedersen Merkle tree of the merkle-tree example
* :mod:`.simple_payments` — the account ledger (serial path) and its transactions
* :mod:`.run` — the demo driver (``python -m simpleworks_tpu_torch.examples.run``)
"""

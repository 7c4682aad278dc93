"""Reference workloads on the port.

* :mod:`.manual_constraints` — raw R1CS equality circuit
* :mod:`.test_circuit` — two UInt8 witnesses constrained equal
* :mod:`.schnorr_circuit` — the schnorr-verify circuit of the bench prove
"""

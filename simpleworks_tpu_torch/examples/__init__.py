"""Reference workloads on the port.

* :mod:`.manual_constraints` — raw R1CS equality circuit
"""

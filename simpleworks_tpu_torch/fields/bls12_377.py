"""BLS12-377 field instantiations (arkworks 0.3 parameter conventions).

The reference binds everything to ``ConstraintF = ark_ed_on_bls12_377::Fq ==
ark_bls12_377::Fr`` (reference ``src/gadgets/mod.rs:29``, SURVEY.md key-field
identity).  Derivation from the BLS parameter x = 0x8508c00000000001:

* ``r = x^4 - x^2 + 1``  (253-bit scalar field, 2-adicity 47 — NTT friendly)
* ``q = (x-1)^2 * r / 3 + x``  (377-bit base field, 2-adicity 46)

Both verified prime; generator 22 for Fr verified to give a full-order
two-adic root of unity (see tests/test_fields.py).
"""

from __future__ import annotations

from .host import make_field

# BLS parameter
X = 0x8508C00000000001

# Scalar field Fr (== ed-on-bls12-377 base field == ConstraintF)
FR_MODULUS = X**4 - X**2 + 1
assert FR_MODULUS == 8444461749428370424248824938781546531375899335154063827935233455917409239041

# Base field Fq
FQ_MODULUS = (X - 1) ** 2 * FR_MODULUS // 3 + X

# ed-on-bls12-377 scalar field (Schnorr secret keys live here)
FR_ED_MODULUS = 2111115437357092606062206234695386632838870926408408195193685246394721360383

Fr = make_field("Fr", FR_MODULUS, n_u64_limbs=4, generator=22)
Fq = make_field("Fq", FQ_MODULUS, n_u64_limbs=6, generator=15)
FrEd = make_field("FrEd", FR_ED_MODULUS, n_u64_limbs=4, generator=7)

# ConstraintF: the field every circuit in the reference is synthesized over.
ConstraintF = Fr

TWO_ADICITY_FR = 47
_t_odd = (FR_MODULUS - 1) >> TWO_ADICITY_FR
#: primitive 2^47-th root of unity (generator 22, arkworks convention)
TWO_ADIC_ROOT_OF_UNITY_FR = pow(22, _t_odd, FR_MODULUS)


def fr_root_of_unity(n: int) -> int:
    """Primitive n-th root of unity in Fr for power-of-two n <= 2^47."""
    assert n & (n - 1) == 0 and n > 0
    log_n = n.bit_length() - 1
    assert log_n <= TWO_ADICITY_FR, f"domain size 2^{log_n} exceeds 2-adicity"
    return pow(TWO_ADIC_ROOT_OF_UNITY_FR, 1 << (TWO_ADICITY_FR - log_n), FR_MODULUS)

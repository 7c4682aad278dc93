"""The port's FrVec, Radix2Domain and DensePoly (simpleworks_tpu_torch.fields.frvec,
poly.domain, poly.dense) held against the JAX package's host twins on the
CPU, tolerance 0, with ``FrVec.spmv`` on repeated outputs."""

import os

import numpy as np
import pytest
import torch

from simpleworks_tpu.fields import dvec as ref_dvec
from simpleworks_tpu.fields.frvec import FrVec as RefFrVec
from simpleworks_tpu.poly.dense import DensePoly as RefPoly
from simpleworks_tpu.poly.domain import Radix2Domain as RefDomain
from simpleworks_tpu_torch.fields import dvec
from simpleworks_tpu_torch.fields.bls12_377 import FR_MODULUS as P
from simpleworks_tpu_torch.fields.device import from_reference_limbs
from simpleworks_tpu_torch.fields.frvec import FrVec, SpmvPlan
from simpleworks_tpu_torch.poly.dense import DensePoly
from simpleworks_tpu_torch.poly.domain import Radix2Domain

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

rng = np.random.default_rng(47)


def rand_ints(n):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def port(vals):
    return FrVec.from_ints(vals, CPU)


def test_frvec_ops_match_reference():
    a, b = rand_ints(12), rand_ints(12)
    a[0] = 0  # the inverse keeps zero at zero
    pa, pb, ra, rb = port(a), port(b), RefFrVec.from_ints(a), RefFrVec.from_ints(b)
    for got, ref in (
        (pa + pb, ra + rb), (pa - pb, ra - rb), (pa * pb, ra * rb), (pa.scale(77), ra.scale(77)),
        (pa.inv(), ra.inv()), (pa.rsub_scalar(5), ra.rsub_scalar(5)), (pa.neg(), ra.neg()),
        (FrVec.powers(3, 9, CPU), RefFrVec.powers(3, 9)), (pa.pad_to(15), ra.pad_to(15)),
    ):
        assert got.to_ints() == ref.to_ints()
    assert pa.sum() == ra.sum()
    assert pa[3] == ra[3] and pa[-1] == ra[len(ra) - 1]
    assert port(a[:5] + [0, 0]).nonzero_length() == 5 and FrVec.zeros(3, CPU).is_zero()


def test_spmv_accumulates_repeated_outputs():
    """Runs of 1, 2, 3 and 37 terms on one output (six scan steps), rows
    out of order, and an output no term reaches."""
    rows = [4, 0, 4, 2, 4] + [6] * 37 + [1, 2]
    cols = list(rng.integers(0, 9, size=len(rows)))
    coeffs, x = rand_ints(len(rows)), rand_ints(9)
    got = FrVec.spmv(rows, cols, port(coeffs), port(x), 8)
    ref = RefFrVec.spmv(np.asarray(rows, np.uint32), np.asarray(cols, np.uint32),
                        RefFrVec.from_ints(coeffs), RefFrVec.from_ints(x), 8)
    assert got.to_ints() == ref.to_ints()
    expected = [0] * 8
    for r, c, v in zip(rows, cols, coeffs):
        expected[r] = (expected[r] + v * x[c]) % P
    assert got.to_ints() == expected
    plan = SpmvPlan(rows, cols, port(coeffs), 8)
    assert len(plan.steps) == 6  # ⌈log2 37⌉
    assert plan.apply(port(x)).to_ints() == expected  # a plan is reusable
    assert SpmvPlan([], [], port([]), 3).apply(port(x)).to_ints() == [0, 0, 0]
    with pytest.raises(ValueError):
        SpmvPlan([8], [0], port([1]), 8)


@pytest.mark.parametrize("n", [8, 64])
def test_domain_transforms_match_reference(n):
    d, rd = Radix2Domain(n), RefDomain(n)
    coeffs = rand_ints(n - 3)
    assert d.elements_vec(CPU).to_ints() == rd.elements_vec().to_ints()
    assert d.elements_vec(CPU) is d.elements_vec(CPU)
    assert d.fft_vec(port(coeffs)).to_ints() == rd.fft_vec(RefFrVec.from_ints(coeffs)).to_ints()
    evals = rand_ints(n)
    assert d.ifft_vec(port(evals)).to_ints() == rd.ifft_vec(RefFrVec.from_ints(evals)).to_ints()
    assert d.fft(coeffs) == rd.fft(coeffs) and d.ifft(evals) == rd.ifft(evals)
    shift = 7
    assert d.coset_fft_vec(port(coeffs), shift).to_ints() == \
        rd.coset_fft_vec(RefFrVec.from_ints(coeffs), shift).to_ints()
    assert d.coset_ifft_vec(port(evals), shift).to_ints() == \
        rd.coset_ifft_vec(RefFrVec.from_ints(evals), shift).to_ints()
    assert d.evaluate_vanishing(12345) == rd.evaluate_vanishing(12345)


def test_divide_by_vanishing_matches_reference():
    import jax.numpy as jnp

    d, rd = Radix2Domain(4), RefDomain(4)
    for width in (3, 4, 23):
        vals = rand_ints(width)
        q, r = d.divide_by_vanishing_vec(port(vals))
        rq, rr = rd.divide_by_vanishing_vec(RefFrVec.from_ints(vals))
        assert q.to_ints() == rq.to_ints() and r.to_ints() == rr.to_ints()
    limbs = port(vals).t
    q, r = dvec.divide_by_vanishing(limbs, 4)
    rq, rr = ref_dvec.divide_by_vanishing(jnp.asarray(limbs.numpy().astype(np.uint32)), 4)
    assert np.array_equal(q.numpy(), np.asarray(rq).astype(np.int32))
    assert np.array_equal(r.numpy(), np.asarray(rr).astype(np.int32))


def test_lagrange_coeffs_match_reference():
    d, rd = Radix2Domain(8), RefDomain(8)
    for point in (98765, rd.element(3)):  # off the domain, and on it
        assert d.lagrange_coeffs_vec(point, CPU).to_ints() == rd.lagrange_coeffs_vec(point).to_ints()


def test_dense_poly_ops_match_reference():
    a, b = rand_ints(6) + [0, 0], rand_ints(70)
    pa, pb, ra, rb = DensePoly(a, CPU), DensePoly(b, CPU), RefPoly(a), RefPoly(b)
    assert pa.degree() == ra.degree() == 5
    for got, ref in ((pa + pb, ra + rb), (pb - pa, rb - ra), (pa.scale(9), ra.scale(9)),
                     (pa * pa, ra * ra), (pa * pb, ra * rb),
                     (pa.mul_by_vanishing(Radix2Domain(4)), ra.mul_by_vanishing(RefDomain(4)))):
        assert got.coeffs == ref.coeffs
    (q, r), (rq, rr) = pb.divide_by_linear(4242), rb.divide_by_linear(4242)
    assert q.coeffs == rq.coeffs and r == rr
    assert pb.evaluate(31337) == rb.evaluate(31337)
    evals = rand_ints(8)
    assert DensePoly.from_evals(Radix2Domain(8), port(evals)).coeffs == \
        RefPoly.from_evals(RefDomain(8), RefFrVec.from_ints(evals)).coeffs
    assert DensePoly.zero(CPU).is_zero() and (pa - pa).is_zero()


def test_frvec_bridges_and_helpers_match_reference():
    """The standard-form [N, 4] u64 arrays (the serde's layout), the device
    limbs, ``copy``, ``mul_add``, ``horner`` and ``div_linear`` against the
    reference's FrVec on the same values."""
    a, b, c = rand_ints(13), rand_ints(13), rand_ints(13)
    a[1], a[2] = 0, P - 1
    pa, ra = port(a), RefFrVec.from_ints(a)
    std = pa.to_std_array()
    assert std.dtype == np.dtype("<u8") and std.shape == (13, 4)
    assert np.array_equal(std, ra.to_std_array())
    assert FrVec.from_std_array(ra.to_std_array(), CPU).to_ints() == a
    assert np.array_equal(dvec.to_standard(FrVec.from_std_array(std, CPU).t), dvec.to_standard(pa.t))
    limbs = pa.to_device_limbs()
    assert np.array_equal(limbs.numpy().astype(np.uint32).T, ra.to_device_limbs())
    assert FrVec.from_device_limbs(from_reference_limbs(ra.to_device_limbs().T, CPU)).to_ints() == a
    assert FrVec.from_device_limbs(limbs).t is limbs
    dup = pa.copy()
    dup.t[:, 0] = 0
    assert pa.to_ints() == a and dup.t.data_ptr() != pa.t.data_ptr()
    assert pa.mul_add(port(b), port(c)).to_ints() == \
        ra.mul_add(RefFrVec.from_ints(b), RefFrVec.from_ints(c)).to_ints()
    z = rand_ints(1)[0]
    assert pa.horner(z) == ra.horner(z) and FrVec.zeros(0, CPU).horner(z) == 0
    quot, rem = pa.div_linear(z)
    ref_quot, ref_rem = ra.div_linear(z)
    assert quot.to_ints() == ref_quot.to_ints() and rem == ref_rem
    empty_q, empty_r = FrVec.zeros(0, CPU).div_linear(z)
    assert len(empty_q) == 0 and empty_r == 0


@pytest.mark.parametrize("size, n_coeffs", [(8, 8), (8, 21), (16, 5)])
def test_domain_list_forms_match_reference(size, n_coeffs):
    """``coset_fft``, ``coset_ifft``, ``divide_by_vanishing`` (below,
    at and above n coefficients) and ``lagrange_coeffs_at`` (off and on the
    domain) against the reference's list oracles; ``DensePoly.constant``."""
    d, rd = Radix2Domain(size), RefDomain(size)
    coeffs = rand_ints(min(n_coeffs, size))
    shift = 22
    evals = d.coset_fft(coeffs, shift, CPU)
    assert evals == rd.coset_fft(coeffs, shift)
    assert d.coset_ifft(evals, shift, CPU) == rd.coset_ifft(evals, shift) == \
        coeffs + [0] * (size - len(coeffs))
    wide = rand_ints(n_coeffs)
    wide[-1] = 0  # a trailing zero the quotient trims
    assert d.divide_by_vanishing(wide, CPU) == rd.divide_by_vanishing(wide)
    z = rand_ints(1)[0]
    assert d.lagrange_coeffs_at(z, CPU) == rd.lagrange_coeffs_at(z)
    on_domain = rd.elements()[3]
    assert d.lagrange_coeffs_at(on_domain, CPU) == rd.lagrange_coeffs_at(on_domain)
    assert DensePoly.constant(z, CPU).coeffs == RefPoly.constant(z).coeffs == [z]
    assert DensePoly.constant(0, CPU).is_zero() and RefPoly.constant(0).is_zero()

"""The plain versions of the port's fused G1 point adds
(simpleworks_tpu_torch.ops.g1_fused) held limb for limb against the
arithmetic of the reference's fused Pallas kernels, and against the host
point law, on every lane case: general, p the identity, q the identity, both
the identity, q = p (doubling) and q = -p.

The reference kernels run eagerly on numpy arrays in place of their refs (no
jit, no Pallas): the Pallas interpreter's compile of these kernels is
impractical off the TPU, which the reference's own tests note.  For the
call, the reference module's ``jnp`` is numpy: its limb arithmetic is
wrapping uint32 add, subtract, multiply, shift and where, which numpy and
XLA compute alike, and numpy runs its ~100,000 one-row slices a hundred
times faster than eager JAX dispatch."""

import os

import numpy as np
import pytest
import torch

from chip_smoke import G1_CASES, g1_inputs
from simpleworks_tpu.fields.bls12_377 import Fq as RefFq
from simpleworks_tpu.ops import g1_fused_pallas as ref_fused
from simpleworks_tpu_torch.fields.device import from_reference_limbs, to_reference_limbs
from simpleworks_tpu_torch.ops import g1_fused, g1_limb

CPU = torch.device("cpu")
os.environ.setdefault("SWTPU_THREADS", "1")  # the native runtime's pool, read once a process
torch.set_num_threads(1)  # tiny tensors: more threads only contend with the other test workers

#: six lanes of the six cases, two general ones
LANES = 8


@pytest.fixture(scope="module")
def operands():
    ins = g1_inputs(LANES, 21, CPU)
    assert ins["cases"][: len(G1_CASES)] == list(G1_CASES)
    return ins


@pytest.fixture
def numpy_reference(monkeypatch):
    monkeypatch.setattr(ref_fused, "jnp", np)


def reference_planes(planes):
    return tuple(to_reference_limbs(a) for a in planes)


def same_planes(port, ref):
    return all(torch.equal(a, from_reference_limbs(np.asarray(b), CPU)) for a, b in zip(port, ref))


def host_sums(ins):
    return [p.add(q) for p, q in zip(ins["p"], ins["q"])]


def test_fused_madd_plain_matches_reference_kernel_math(operands, numpy_reference):
    got = g1_fused.fused_madd_plain(operands["p3"], operands["q2"])
    expected = ref_fused.madd_math_eager(reference_planes(operands["p3"]),
                                         reference_planes(operands["q2"]))
    assert same_planes(got, expected)
    assert g1_limb.points_from_limb_major(got) == host_sums(operands)


def test_fused_add_plain_matches_reference_kernel_body(operands, numpy_reference):
    L, Q = ref_fused.L, ref_fused.Q
    p_limbs = np.array([[(Q >> (16 * i)) & 0xFFFF] for i in range(L)], dtype=np.uint32)
    r = RefFq.PARAMS.montgomery_r % Q
    one = np.array([[(r >> (16 * i)) & 0xFFFF] for i in range(L)], dtype=np.uint32)
    n0 = (-pow(Q, -1, 1 << 16)) % (1 << 16)
    outs = [np.zeros((L, LANES), dtype=np.uint32) for _ in range(3)]
    ref_fused._fused_add_kernel(*reference_planes(operands["p3"]),
                                *reference_planes(operands["q3"]), p_limbs, one, *outs, n0=n0)
    got = g1_fused.fused_add_plain(operands["p3"], operands["q3"])
    assert same_planes(got, outs)
    assert g1_limb.points_from_limb_major(got) == host_sums(operands)


def test_wrappers_take_the_plain_versions_on_the_cpu(operands):
    """On CPU tensors the wrappers (and g1_limb's adds) are the plain
    versions, and nothing is counted as a kernel launch."""
    before = dict(g1_fused.LAUNCHES)
    p3, q3, q2 = operands["p3"], operands["q3"], operands["q2"]
    assert same_planes(g1_limb.add(p3, q3), reference_planes(g1_fused.fused_add_plain(p3, q3)))
    assert same_planes(g1_limb.madd(p3, q2), reference_planes(g1_fused.fused_madd_plain(p3, q2)))
    assert g1_fused.LAUNCHES == before
    with pytest.raises(ValueError):
        g1_fused.fused_madd(p3, q3)  # an (x, y) pair, not a triple
    with pytest.raises(TypeError):
        g1_fused.fused_add(p3, tuple(a.to(torch.int64) for a in q3))

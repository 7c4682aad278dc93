"""Faults planted under a run's timed path, for the control and the fault
tests: each patches the program in this process and returns its undo.

* ``top_window`` (the control, planted before set-up): every scalar loses
  its bits 247..255, the last window of width 13, as an MSM that counts
  floor(253/c) windows instead of ceil(253/c) would: the setup's fixed-base
  powers (on the card and in the native runtime) and every MSM of a commit
  or an opening.
* ``half_batch``: every MSM sums only the first half of its terms.
* ``answer_altered``: every commitment leaves ``kzg10.commit`` with G added.

The two faults are planted after set-up, under the timed path alone.
"""

from __future__ import annotations

from ..reference.field import MONT_R, R


def top_window():
    import numpy as np

    from simpleworks_tpu_torch import native
    from simpleworks_tpu_torch.fields import dvec
    from simpleworks_tpu_torch.fields.device import FR, mont_scalar
    from simpleworks_tpu_torch.kzg import kzg10

    plain_msm, plain_fixed, plain_native = (kzg10._srs_msm, kzg10.fixed_base_powers_affine,
                                            native.g1_fixed_base_arr)

    def msm(srs, coeffs, offset=0):
        std = dvec.to_standard(coeffs).clone()
        std[15] &= 0x7F  # limb 15 holds bits 240..255: keep 240..246
        return plain_msm(srs, dvec.scale(std, mont_scalar(MONT_R % R, FR, coeffs.device)),
                         offset)

    def fixed(g, scalars_std):
        low = scalars_std.clone()
        low[15] &= 0x7F
        return plain_fixed(g, low)

    def fixed_native(g, scalars):
        low = np.array(scalars, copy=True)
        low[:, 3] &= np.uint64((1 << 55) - 1)  # word 3 holds bits 192..255: keep to 246
        return plain_native(g, low)

    kzg10._srs_msm, kzg10.fixed_base_powers_affine = msm, fixed
    native.g1_fixed_base_arr = fixed_native

    def forget():  # the program's in-process memos of SRS and index
        from simpleworks_tpu_torch import marlin

        kzg10._SRS_MEMO.clear()
        marlin._INDEX_MEMO.clear()

    def undo():
        kzg10._srs_msm, kzg10.fixed_base_powers_affine = plain_msm, plain_fixed
        native.g1_fixed_base_arr = plain_native
        forget()

    forget()
    return undo


def half_batch():
    from simpleworks_tpu_torch.kzg import kzg10

    plain = kzg10._srs_msm

    def msm(srs, coeffs, offset=0):
        return plain(srs, coeffs[:, : max(1, coeffs.shape[1] // 2)], offset)

    kzg10._srs_msm = msm
    return lambda: setattr(kzg10, "_srs_msm", plain)


def answer_altered():
    from simpleworks_tpu_torch.curves.bls12_377 import G1Point
    from simpleworks_tpu_torch.kzg import kzg10

    plain = kzg10.commit

    def commit(*args, **kwargs):
        out = plain(*args, **kwargs)
        comm = out[0] if isinstance(out, tuple) else out
        comm.comm = comm.comm.add(G1Point.generator())
        return out

    kzg10.commit = commit
    return lambda: setattr(kzg10, "commit", plain)


#: name -> (the stage it is planted at, the function that plants it)
FAULTS = {"top_window": ("setup", top_window), "half_batch": ("window", half_batch),
          "answer_altered": ("window", answer_altered)}


def planter(name: str, undo: list):
    """A ``stage_hook`` for :func:`..harness.run_cell` that plants fault
    ``name`` (or nothing for ``"none"``) at its stage, its undo appended to
    ``undo``."""
    stage = FAULTS[name][0] if name != "none" else None

    def hook(at: str, _traffic) -> None:
        if at == stage:
            undo.append(FAULTS[name][1]())

    return hook

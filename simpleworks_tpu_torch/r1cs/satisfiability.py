"""Device-batched R1CS satisfiability: Az ∘ Bz − Cz == 0 for a batch of
assignments to one circuit structure, as sparse products on the device.

Port of ``simpleworks_tpu/r1cs/satisfiability.py`` (``DeviceR1CS``), over
the port's ``[16, N]`` int32 Montgomery layout.  Each matrix is one
:class:`~simpleworks_tpu_torch.fields.frvec.SpmvPlan`, built once, and a
batch runs through it in one call with the assignments laid end to end in
the lane axis (``SpmvPlan.apply_batch``): the mod-mul, mod-add and mod-sub
kernels on the card, their plain versions on the CPU.

Departure from the reference: its row sums are lazy 16-bit limb sums
reduced once at the end (``_reduce_wide_sum``), which is right only while a
row has fewer than 2^15 terms; the plan's segmented scan of modular adds
folds any number of terms a row.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..device import resolve
from ..fields import dvec
from ..fields.frvec import FrVec, SpmvPlan


class DeviceR1CS:
    """One circuit structure on ``device`` (the card unless the caller names
    another), built from a synthesized constraint system's matrices and
    evaluated over batches of full assignments z = [1, instances...,
    witnesses...]."""

    def __init__(self, cs, device=None):
        self.device = resolve(device)
        self.num_constraints = cs.num_constraints
        self.num_cols = cs.num_instance_variables + cs.num_witness_variables
        self.plans = [
            SpmvPlan(rows, cols, FrVec.from_ints(coeffs, self.device), self.num_constraints)
            for rows, cols, coeffs in cs.to_matrices()
        ]

    def to_mont(self, assignments: Sequence[Sequence[int]]) -> torch.Tensor:
        """Standard-form rows -> [16, batch·num_cols] Montgomery limbs, the
        rows end to end."""
        flat = []
        for row in assignments:
            if len(row) != self.num_cols:
                raise ValueError(f"an assignment of {len(row)} values, the circuit has "
                                 f"{self.num_cols} columns")
            flat.extend(row)
        return dvec.from_ints(flat, self.device)

    def matvec(self, plan: SpmvPlan, z_mont: torch.Tensor, batch: int) -> torch.Tensor:
        """[16, batch·num_cols] -> [16, batch·num_constraints] sparse product."""
        return plan.apply_batch(z_mont, batch)

    def check(self, assignments: Sequence[Sequence[int]]) -> torch.Tensor:
        """Satisfiability of each assignment: bool [batch] on the device."""
        return self._check_mont(self.to_mont(assignments), len(assignments))

    def _check_mont(self, z_mont: torch.Tensor, batch: int) -> torch.Tensor:
        if batch == 0:
            return torch.ones(0, dtype=torch.bool, device=self.device)
        az, bz, cz = (self.matvec(plan, z_mont, batch) for plan in self.plans)
        diff = dvec.sub(dvec.mul(az, bz), cz)  # canonical: zero iff every limb is 0
        return ~(diff != 0).reshape(dvec.L, batch, self.num_constraints).any(dim=2).any(dim=0)

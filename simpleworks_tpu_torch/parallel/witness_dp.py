"""Batched witness checking over a list of devices: one circuit structure,
a batch of assignments split into contiguous shards, one shard a device.

Port of ``simpleworks_tpu/parallel/witness_dp.py``.  The reference runs the
shards as one ``shard_map`` program and sums the failures with a ``psum``;
the port issues each shard's check on its device from one thread (the card
queues the launches, so shards on distinct cards overlap), then reads the
verdicts back and sums the failures on the host.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from ..device import resolve
from ..r1cs.satisfiability import DeviceR1CS


def make_sharded_checker(devices, cs) -> Callable[[Sequence[Sequence[int]]], tuple]:
    """A checker over ``devices`` for ``cs``'s structure (one
    :class:`DeviceR1CS` a distinct device): it takes a batch whose length is
    a multiple of ``len(devices)`` and returns (verdicts, a host bool tensor
    [batch]; the number of failures)."""
    devices = [resolve(d) for d in devices]
    checkers = {dev: DeviceR1CS(cs, dev) for dev in dict.fromkeys(devices)}

    def check(batch):
        if len(batch) % len(devices):
            raise ValueError(f"a batch of {len(batch)} does not split over {len(devices)} devices")
        per = len(batch) // len(devices)
        shards = [checkers[dev].check(batch[k * per:(k + 1) * per])
                  for k, dev in enumerate(devices)]
        ok = torch.cat([s.cpu() for s in shards])
        return ok, int((~ok).sum())

    return check


def sharded_check_host(devices, cs, assignments) -> list[bool]:
    """Satisfiability of each assignment (standard-form rows z = [1,
    instances..., witnesses...]) of ``cs``'s structure: the batch padded to
    a multiple of ``len(devices)`` with ``cs``'s own (satisfying) assignment,
    checked shard by shard; the first ``len(assignments)`` verdicts."""
    rows = [list(r) for r in assignments]
    n = len(rows)
    if n == 0:
        return []
    satisfying = cs.full_assignment()
    while len(rows) % len(devices):
        rows.append(satisfying)
    ok, _failures = make_sharded_checker(devices, cs)(rows)
    return [bool(v) for v in ok[:n]]

"""Multi-process plumbing for the sharded prover, over ``torch.distributed``.

Port of ``simpleworks_tpu/parallel/multihost.py``.  The reference joins a
``jax.distributed`` job and runs one SPMD program over a global mesh; here
each process (a rank) joins a ``torch.distributed`` process group, and the
sharded planes (:mod:`.ntt_sharded`, :mod:`.msm_sharded`, routed by
:mod:`..ops.accel`) run over a *global* device list: every rank's local
devices in rank order (:func:`global_devices`), the other ranks' entries
None.  A multi-process job changes two mechanical things and nothing else:

* **placing**: every rank holds the same full host data (the prover's data
  is computed deterministically on each rank) and places only its own
  shards on its own devices (:func:`put_global`), so the ranks compute their
  shards at the same time;
* **fetching**: an ``all_gather`` gives every rank every shard's result
  (:func:`fetch_global`), so each rank goes on with the whole value and
  proves the same bytes as a single process.

Collectives use the ``gloo`` backend on CPU tensors: a shard's result is
copied from its card to the host before the collective and back to the
card after it.  Every rank must have the same number of local devices.
NCCL refuses two ranks on one card, and the one-card machine runs two ranks
on ``cuda:0``; NCCL across cards waits for a cell with four cards.

The group is given its address explicitly (:func:`initialize`:
``tcp://localhost:<port>`` or ``file://<path>``, the world size and this
process's rank); nothing discovers a cluster.
"""

from __future__ import annotations

from datetime import timedelta

import torch
import torch.distributed as dist

#: seconds a collective waits for the other ranks before it raises
DEFAULT_TIMEOUT_S = 600


def initialize(init_method: str, world_size: int, rank: int, backend: str = "gloo",
               timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Join a ``world_size``-process job as ``rank`` (``init_method``:
    ``tcp://localhost:<port>`` or ``file://<path>``)."""
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, timeout=timedelta(seconds=timeout_s))


def shutdown() -> None:
    """Leave the job (a no-op outside one)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def in_job() -> bool:
    """Whether this process has joined a job (a world of one included)."""
    return dist.is_available() and dist.is_initialized()


def is_multiprocess() -> bool:
    return in_job() and dist.get_world_size() > 1


def rank() -> int:
    return dist.get_rank() if in_job() else 0


def world_size() -> int:
    return dist.get_world_size() if in_job() else 1


def global_devices(local_devices) -> list:
    """This rank's devices as a global list: ranks × local devices in rank
    order, the other ranks' entries None (the local list itself outside a
    job)."""
    local = [torch.device(d) for d in local_devices]
    if not in_job():
        return local
    out: list = []
    for r in range(world_size()):
        out.extend(local if r == rank() else [None] * len(local))
    return out


def put_global(x: torch.Tensor, devices, dim: int = -1) -> list:
    """Split ``x`` (the same full data on every rank) into ``len(devices)``
    contiguous shards along ``dim`` (⌈size/D⌉ each, the last the rest; a
    shard past the end is empty) and place this rank's shards on their
    devices: the list of shards, None for the other ranks'."""
    size = x.shape[dim]
    per = -(-size // len(devices))
    out = []
    for k, dev in enumerate(devices):
        if dev is None:
            out.append(None)
            continue
        lo = min(size, k * per)
        out.append(x.narrow(dim, lo, min(size, lo + per) - lo).to(dev))
    return out


def fetch_global(parts: list) -> list:
    """Every shard's result on every rank: ``parts`` holds this rank's
    results (tensors of one shape for every shard of the job) and None for
    the other ranks'.  Outside a job the list comes back as it is; in one
    (a world of one included) one ``all_gather`` over the host returns every
    shard, as CPU tensors, in shard order."""
    if not in_job():
        return list(parts)
    mine = torch.stack([p.cpu() for p in parts if p is not None])
    gathered = [torch.empty_like(mine) for _ in range(world_size())]
    dist.all_gather(gathered, mine)
    return [g[i] for g in gathered for i in range(g.shape[0])]

"""Sharded-prover routing: when a list of devices is configured, the
prover's large NTTs take the sharded 4-step transform
(:mod:`simpleworks_tpu_torch.parallel.ntt_sharded`) and its large commits
the sharded MSM (:mod:`simpleworks_tpu_torch.parallel.msm_sharded`); in a
multi-process job (:mod:`..parallel.multihost`) the list spans every rank's
devices.  Both routes give the same values as the unsharded ones, so a
proof's bytes do not depend on the routing.

Port of the sharded-routing half of ``simpleworks_tpu/ops/accel.py``
(``set_prover_mesh``, ``prover_mesh``, ``use_sharded_ntt``,
``use_sharded_msm``), over a device list instead of a mesh.  The thresholds
are module constants (the reference also reads them from the environment).
The reference's device probes, link measurements and compile cache are not
ported.  Nor is its size routing (``use_device_*``, which keeps small work
on the host): the port keeps the device its caller resolved, so a key on
the card is indexed and proved on the card at every size, and the host
route (the native runtime, :mod:`..native`) runs when the caller names the
CPU.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG

#: transforms of at least this many points shard when devices are configured
SHARDED_NTT_THRESHOLD = 1 << 14
#: MSMs of at least this many points shard when devices are configured
SHARDED_MSM_THRESHOLD = 1 << 16

_PROVER_DEVICES: list[torch.device] | None = None


def set_prover_devices(devices) -> None:
    """Routes the prover's large transforms and MSMs over ``devices`` (a
    list, which may repeat a device); ``None`` clears it."""
    global _PROVER_DEVICES
    _PROVER_DEVICES = None if devices is None else [torch.device(d) for d in devices]


def prover_devices() -> list | None:
    """The devices set by :func:`set_prover_devices`, else the first
    ``DEFAULT_CONFIG.mesh_devices`` CUDA cards when that is more than one
    and the process sees as many, else None (one device: no sharding).  In
    a multi-process job the list is global: every rank's devices in rank
    order, the other ranks' entries None (``multihost.global_devices``)."""
    if _PROVER_DEVICES is not None:
        from ..parallel import multihost

        return multihost.global_devices(_PROVER_DEVICES)
    n = DEFAULT_CONFIG.mesh_devices or 0
    if n <= 1 or not torch.cuda.is_available() or torch.cuda.device_count() < n:
        return None
    return [torch.device("cuda", i) for i in range(n)]


def use_sharded_ntt(n: int) -> bool:
    return n >= SHARDED_NTT_THRESHOLD and prover_devices() is not None


def use_sharded_msm(n: int) -> bool:
    return n >= SHARDED_MSM_THRESHOLD and prover_devices() is not None

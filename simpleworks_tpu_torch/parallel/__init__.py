"""The parallel planes, over an explicit list of devices: batched R1CS
checks (:mod:`.witness_dp`), the proof pipeline (:mod:`.proof_pipeline`),
the sharded 4-step NTT (:mod:`.ntt_sharded`) and the sharded MSM
(:mod:`.msm_sharded`), in one process or across several
(:mod:`.multihost`, a ``torch.distributed`` job).

Port of ``simpleworks_tpu/parallel/``.  The reference shards over a
``jax.sharding.Mesh`` with ``shard_map``; the port's counterpart of a mesh is
a list of ``torch.device``s, which may repeat a device (the CPU tests use
``["cpu"] * 8``, standing in for the reference's 8 virtual CPU devices).
Each ``*_host`` wrapper takes the list; :func:`default_devices` builds it
from the typed config.  The reference's multi-process plane
(``parallel/multihost.py``, a ``jax.distributed`` job) is ported over
``torch.distributed`` (gloo): the sharded planes then take a global device
list across the ranks.
"""

from __future__ import annotations

import torch

from ..config import DEFAULT_CONFIG
from ..device import default_device, resolve


def default_devices(device=None) -> list[torch.device]:
    """The devices the parallel planes run on: by default the first
    ``DEFAULT_CONFIG.mesh_devices`` CUDA cards (all of them when that is
    None), raising without a card; ``[device]`` when the caller names one
    (``"cpu"`` for the CPU).  Counterpart of the reference's
    ``default_mesh``."""
    if device is not None:
        return [resolve(device)]
    default_device()  # raises without a card
    count = torch.cuda.device_count()
    n = DEFAULT_CONFIG.mesh_devices or count
    return [torch.device("cuda", i) for i in range(min(n, count))]

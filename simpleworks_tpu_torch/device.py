"""Where the port's entry points put their tensors.

Every public function with a ``device`` parameter takes ``device=None`` and
resolves it here: the card, unless the caller names another device (the CPU
tests pass ``device="cpu"``).  There is no fallback: without a CUDA card the
default raises.
"""

from __future__ import annotations

import torch


def default_device() -> torch.device:
    """The current CUDA card; raises when PyTorch sees none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: the port runs on the card by default; "
            'pass device="cpu" to run on the CPU'
        )
    return torch.device("cuda", torch.cuda.current_device())


def resolve(device=None) -> torch.device:
    """``device`` as a ``torch.device`` with its card's index (as a tensor's
    ``.device`` has it, so the two compare equal); ``None`` means
    :func:`default_device`."""
    if device is None:
        return default_device()
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return default_device()
    return device

"""The benchmark's tests write no SRS or proving-key checkpoint; tests that
need the card skip without one (marker ``cuda``), decided in the fixture."""

import pytest


@pytest.fixture(autouse=True)
def _no_disk_checkpoints(monkeypatch):
    monkeypatch.setenv("SWTPU_SRS_DISK_CACHE", "0")
    monkeypatch.setenv("SWTPU_PK_DISK_CACHE", "0")


@pytest.fixture
def cuda_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: run on the card with pytest -m cuda benchmark/tests")
    return torch.device("cuda", 0)

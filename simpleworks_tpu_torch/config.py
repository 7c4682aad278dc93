"""Typed configuration (SURVEY.md §5.6: the reference's configuration is
types/constants — Marlin aliases, Pedersen windows, SRS sizes, Poseidon
shape).  This dataclass pins those values as defaults and adds the mesh
shape for the parallel axes.

Port of ``simpleworks_tpu/config.py`` (pure Python, copied so the port
imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class FrameworkConfig:
    # curve / field (reference Cargo.toml:17-18, src/gadgets/mod.rs:29)
    curve: str = "bls12-377"
    embedded_curve: str = "ed-on-bls12-377"

    # Pedersen windows (reference src/merkle_tree/common.rs:16-29)
    leaf_window: tuple[int, int] = (4, 144)       # (window_size, num_windows)
    two_to_one_window: tuple[int, int] = (4, 128)

    # Poseidon (reference src/hash/helpers.rs:7,572-574)
    poseidon_alpha: int = 17
    poseidon_rounds: tuple[int, int] = (8, 29)    # (full, partial)
    poseidon_width: int = 3

    # Marlin SRS scales (reference examples; SURVEY.md §6)
    small_srs: tuple[int, int, int] = (100, 25, 300)
    large_srs: tuple[int, int, int] = (100_000, 25_000, 300_000)

    # device mesh for the parallel axes (§2.4)
    mesh_axis: str = "shard"
    mesh_devices: int | None = None  # None = all available


DEFAULT_CONFIG = FrameworkConfig()

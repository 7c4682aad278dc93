"""The one traffic generator: it reads a traffic mix (a data file under
``benchmark/traffic/``) and a configuration, builds the cell's inputs from
the seed in set-up, and issues the requests of a closed loop.

A mix's ``kind`` names its request, found by name as the file
``benchmark/kinds/<kind>.py``: a module whose class ``Kind`` (a
:class:`Traffic`) fills ``setup``, ``warm``, ``request``, ``record`` and
``check``.  A new kind of request is a new file there; a new mix of a kind
is a new data file.  The program is imported inside the methods, never at
module level."""

from __future__ import annotations

import importlib.util
import re
import time
from contextlib import contextmanager
from pathlib import Path

#: a name of a kind, as BENCHMARK.json's names are spelled
KIND_NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def jacobian(point) -> tuple:
    """A program's G1 point as the reference's (X, Y, Z) integers."""
    return (point.X, point.Y, point.Z)


def load_module(path: Path, name: str):
    """The Python file at ``path`` as a module named ``name``."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


class Traffic:
    """One cell's inputs, requests and correctness check over the cell's
    ``devices`` (``device`` is the first).  ``mark(stage)`` closes a stage
    of set-up: the result line gives each stage's seconds."""

    def __init__(self, config: dict, mix: dict, seed: int, devices: list, root: Path):
        self.config, self.mix, self.seed, self.root = config, mix, seed, root
        self.devices, self.device = list(devices), devices[0]
        self.marks: list[tuple[str, float]] = []

    def mark(self, stage: str) -> None:
        self.marks.append((stage, time.perf_counter()))

    def setup(self) -> None:
        raise NotImplementedError

    def warm(self) -> None:
        raise NotImplementedError

    def request(self, i: int):
        raise NotImplementedError

    def record(self, i: int, out):
        raise NotImplementedError

    def check(self, records: list) -> dict:
        raise NotImplementedError

    def snapshot(self) -> dict:
        """The program's launch counts and span totals so far."""
        from simpleworks_tpu_torch.ops._build import LAUNCHES
        from simpleworks_tpu_torch.utils.observability import PROVER_TIMER

        return {"launches": dict(LAUNCHES), "spans": dict(PROVER_TIMER.totals)}

    @contextmanager
    def traced(self):
        """The traced run: the prover's regions synchronise the card and
        open a profiler span each, for the per-layer metrics."""
        import torch

        from simpleworks_tpu_torch.utils.observability import PROVER_TIMER

        plain = PROVER_TIMER.region
        self.span_labels: set[str] = set()

        @contextmanager
        def region(label):
            self.span_labels.add(label)
            with torch.profiler.record_function(label), plain(label):
                yield

        PROVER_TIMER.synchronize = True
        PROVER_TIMER.region = region
        try:
            yield
        finally:
            del PROVER_TIMER.region
            PROVER_TIMER.synchronize = False


def make(config: dict, mix: dict, seed: int, devices: list, root: Path) -> Traffic:
    """The traffic of ``mix``: its kind's class from
    ``<root>/benchmark/kinds/<kind>.py``, over ``devices``."""
    kind = mix.get("kind")
    path = root / "benchmark" / "kinds" / f"{kind}.py"
    if not isinstance(kind, str) or not KIND_NAME.match(kind) or not path.is_file():
        known = sorted(p.stem for p in (root / "benchmark" / "kinds").glob("*.py"))
        raise ValueError(f"unknown traffic kind {kind!r}: expected one of {known}")
    if mix.get("loop", "closed") != "closed" or mix.get("clients", 1) != 1:
        raise ValueError("the generator runs a closed loop with one client")
    module = load_module(path, f"bench_kind_{kind.replace('.', '_').replace('-', '_')}")
    return module.Kind(config, mix, seed, devices, root)

"""On the card (marker ``cuda``; skips without one): each cell through the
command for a short window, correct, with the device's fields; and the
control, every scalar's top window dropped, judged not correct at the
cell's own size.  On the card, keep the repository's root conftest (which
loads JAX for the CPU tests) out of the process:

    python -m pytest -m cuda --confcutdir=benchmark/tests benchmark/tests
"""

import json
import subprocess
import sys

import pytest

from benchmark.tests.tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in SPEC["workloads"]]


def command(script, *args):
    proc = subprocess.run([sys.executable, f"benchmark/{script}", *args], capture_output=True,
                          text=True, cwd=ROOT, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_runs_correct(cuda_card, cell):
    line = command("run.py", "--workload", cell, "--seed", "2147490001", "--seconds", "3",
                   "--trace", "0")[-1]
    assert line["correct"] and line["failed"] == 0
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert line["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cuda_card, cell):
    lines = command("control.py", "--workload", cell, "--seconds", "3", "--fault",
                    "top_window", "--seeds", "2147490002")
    assert lines and not any(line["correct"] for line in lines)

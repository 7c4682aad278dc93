"""The port stands alone: importing every module of simpleworks_tpu_torch
loads neither JAX nor the JAX package, and chip_smoke.py refuses to run
without a CUDA card or outside a checkout."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import simpleworks_tpu_torch

ROOT = Path(__file__).resolve().parent.parent

PROBE = """
import importlib, pkgutil, sys
import simpleworks_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "simpleworks_tpu"))
print(len(names), leaked)
sys.exit(1 if leaked else 0)
"""


def run(args, cwd, **env):
    return subprocess.run([sys.executable, *args], capture_output=True, text=True, cwd=cwd,
                          env={**os.environ, **env}, timeout=120)


def test_port_modules_import_no_jax():
    package = Path(simpleworks_tpu_torch.__file__).parent
    expected = len(list(package.rglob("*.py"))) - 1  # every module but the package itself
    proc = run(["-c", PROBE], ROOT)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert proc.stdout.split()[0] == str(expected)


def test_chip_smoke_fails_without_cuda():
    proc = run(["chip_smoke.py"], ROOT, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_chip_smoke_fails_outside_a_checkout(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = run(["chip_smoke.py"], tmp_path, PYTHONPATH="")
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout

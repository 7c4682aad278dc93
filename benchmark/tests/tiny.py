"""A copy of the benchmark in a temporary directory with tiny cells that a
CPU runs in seconds: the real mixes with their sizes cut, a small SRS, and
a configuration whose circuit is the port's two-witness test circuit."""

from __future__ import annotations

import json
import shutil
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

TINY_KZG = {"name": "tiny-kzg", "max_degree": 255, "srs": [64, 64, 128]}
TINY_MARLIN = {"name": "tiny-marlin", "srs": [64, 64, 128], "domain_h": 32, "domain_k": 64}
TINY_MARLIN_BUILD = '''
def build(seed, count, config):
    from simpleworks_tpu_torch.examples import test_circuit

    return [test_circuit.synthesize((seed + j) % 256, (seed + j) % 256) for j in range(count)]
'''
#: each tiny cell: (its real cell, its configuration, the mix's sizes cut)
TINY_CELLS = {
    "tiny.commit-2p20": ("kzg.commit-2p20", "tiny-kzg", {"width": 64, "ring": 3}),
    "tiny.schnorr-tx": ("prove.schnorr-tx", "tiny-marlin", {}),
}


def copy_tree(dest: Path) -> Path:
    """BENCHMARK.json and benchmark/ as the checkout has them, under ``dest``."""
    shutil.copytree(ROOT / "benchmark", dest / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__", ".cache"))
    shutil.copy(ROOT / "BENCHMARK.json", dest / "BENCHMARK.json")
    return dest


def tiny_tree(dest: Path) -> Path:
    """``copy_tree`` with the tiny cells added as new files and entries."""
    copy_tree(dest)
    bench = dest / "benchmark"
    spec = json.loads((dest / "BENCHMARK.json").read_text())
    for config in (TINY_KZG, TINY_MARLIN):
        (bench / "configs" / f"{config['name']}.json").write_text(json.dumps(config))
        spec["configs"].append({"name": config["name"], "source": "a test's tiny size",
                                "file": f"benchmark/configs/{config['name']}.json",
                                "reduced": [], "why": "CPU tests"})
    (bench / "configs" / "tiny-marlin.py").write_text(TINY_MARLIN_BUILD)
    for name, (real, config, cut) in TINY_CELLS.items():
        real_cell = next(c for c in spec["workloads"] if c["name"] == real)
        mix = json.loads((bench / "traffic" / f"{real_cell['traffic']}.json").read_text())
        mix.update(cut)
        traffic = f"tiny-{real_cell['traffic']}"
        (bench / "traffic" / f"{traffic}.json").write_text(json.dumps(mix))
        spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                                  "chips": 1, "why": "CPU tests"})
        for metric in spec["end_to_end"] + spec["per_layer"]:
            if real in metric.get("workloads", []):
                metric["workloads"].append(name)
    (dest / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return dest

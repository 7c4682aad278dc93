"""The harness on the CPU: a tiny dry run of each mix through the port, the
result line's contract, a cell, mix, kind of request and metric added as
files only, the control and the faults that must make ``correct`` false,
and the command's refusals."""

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from benchmark.lib import faults, harness
from benchmark.tests.tiny import ROOT, TINY_CELLS, copy_tree, tiny_tree

SEED = 2**31 + 4321
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    return tiny_tree(tmp_path_factory.mktemp("bench"))


def run(tree, cell, seconds=1.0, trace=False, hook=None, seed=SEED, devices=(CPU,)):
    return harness.run_cell(tree, cell, seed, seconds, trace, devices, time.perf_counter(),
                            stage_hook=hook)


def check_line(result, spec, cell, trace):
    """The result line as the contract states it, ``checks`` last."""
    line = json.loads(json.dumps(result))
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool)
    assert line["attempted"] >= line["failed"] >= 0
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert list(line)[-1] == "checks"
    for check in line["checks"].values():
        assert set(check) == {"value", "limit"}
    expected = {m["name"]: m["unit"] for m in harness.metrics_for(spec, cell, trace)}
    for name, metric in line["metrics"].items():
        assert metric["unit"] == expected[name] and metric["value"] > 0 or name.startswith(
            "launches.")
    return line


@pytest.mark.parametrize("cell", sorted(TINY_CELLS))
def test_dry_run(tree, cell):
    spec = harness.load_spec(tree)
    line = check_line(run(tree, cell), spec, cell, trace=False)
    assert line["correct"], line
    assert line["failed"] == 0 and line["attempted"] >= 1
    # every end-to-end metric of the cell is reported on the CPU too
    assert set(line["metrics"]) == {m["name"] for m in harness.metrics_for(spec, cell, False)}
    assert all(check["value"] == 0 for check in line["checks"].values())
    # set-up's stages add up to setup_s
    stages = line["seconds"]["setup_stages"]
    assert list(stages)[0] == "imports" and list(stages)[-1] == "warm-up"
    assert abs(sum(stages.values()) - line["seconds"]["setup"]) < 1e-6


def test_traced_run_on_the_cpu_reports_the_program_counters(tree):
    spec = harness.load_spec(tree)
    line = check_line(run(tree, "tiny.schnorr-tx", trace=True), spec, "tiny.schnorr-tx", True)
    assert line["correct"]
    # no card: no device metrics, the program's spans and counters are read
    assert {"host_prework_s", "ahp_s", "kzg_s.prove", "launches.prove"} <= set(line["metrics"])
    assert "busy_s" not in line["device"]


@pytest.mark.parametrize("cell", ["tiny.commit-2p20", "tiny.schnorr-tx"])
@pytest.mark.parametrize("fault", sorted(faults.FAULTS))
def test_faults_make_correct_false(tree, cell, fault):
    undo = []
    try:
        line = run(tree, cell, seconds=0.5, hook=faults.planter(fault, undo))
    finally:
        while undo:
            undo.pop()()
    assert line["correct"] is False
    failed = {name for name, c in line["checks"].items() if c["value"] > c["limit"]}
    if fault == "top_window":  # the control fails every number the cell compares
        assert failed == set(line["checks"])
    else:
        assert failed
    # the same seed without the fault is correct
    assert run(tree, cell, seconds=0.5)["correct"]


def test_same_seed_same_inputs(tree):
    from benchmark.lib import generator
    from benchmark.reference import field

    spec = harness.load_spec(tree)
    cell = harness.cell_of(spec, "tiny.commit-2p20")
    config, mix = harness.config_of(spec, tree, cell["config"]), harness.mix_of(tree,
                                                                              cell["traffic"])
    rings = []
    for seed in (SEED, SEED, SEED + 1):
        traffic = generator.make(config, mix, seed, [CPU], tree)
        traffic.setup()
        rings.append(traffic.ring)
    assert torch.equal(rings[0], rings[1]) and not torch.equal(rings[0], rings[2])
    assert (rings[0][:, 15] < (field.R >> 240)).all()
    assert (rings[0][:, :, -1] != 0).any(dim=1).all()


def digests(root: Path) -> dict:
    return {str(p.relative_to(root)): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file() and "__pycache__" not in p.parts}


#: a kind of request that is not the benchmark's: each device's sum of 0..n-1
THROWAWAY_KIND = '''
from benchmark.lib.generator import Traffic


class Kind(Traffic):
    def setup(self):
        import torch

        self.data = [torch.arange(int(self.mix["n"]), device=d) for d in self.devices]
        self.mark("data")

    def warm(self):
        self.request(0)

    def request(self, i):
        return sum(int(x.sum()) for x in self.data)

    def record(self, i, out):
        return out

    def check(self, records):
        n = int(self.mix["n"])
        want = len(self.devices) * n * (n - 1) // 2
        return {"sum_mismatches": (sum(r != want for r in records), 0)}
'''


def add_throwaway_cell(root: Path, name: str, config: str, traffic: str, chips: int = 1):
    spec = json.loads((root / "BENCHMARK.json").read_text())
    spec["configs"].append({"name": config, "source": "a test", "reduced": [],
                            "file": f"benchmark/configs/{config}.json", "why": "a test"})
    spec["workloads"].append({"name": name, "config": config, "traffic": traffic,
                              "chips": chips, "why": "a test"})
    spec["end_to_end"].append({"name": f"{name}_requests", "unit": "1", "better": "higher",
                               "bound": 0.25, "source": "host_clock", "workloads": [name]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    (root / "benchmark" / "metrics" / f"{name}_requests.py").write_text(
        "def read(run):\n    return float(run.completed)\n")


def test_a_cell_mix_kind_and_metric_added_as_files_only(tmp_path):
    copy_tree(tmp_path)
    bench = tmp_path / "benchmark"
    before = digests(bench)
    # a new mix of a kind that is there
    (bench / "configs" / "throwaway-kzg.json").write_text(json.dumps({"max_degree": 63}))
    (bench / "traffic" / "throwaway-ring.json").write_text(
        json.dumps({"kind": "commit", "width": 16, "ring": 2}))
    add_throwaway_cell(tmp_path, "throwaway.ring", "throwaway-kzg", "throwaway-ring")
    # a new kind of request, on two devices
    (bench / "kinds" / "throwaway-sum.py").write_text(THROWAWAY_KIND)
    (bench / "configs" / "throwaway-sum.json").write_text(json.dumps({}))
    (bench / "traffic" / "throwaway-sums.json").write_text(
        json.dumps({"kind": "throwaway-sum", "n": 1000}))
    add_throwaway_cell(tmp_path, "throwaway.sum", "throwaway-sum", "throwaway-sums", chips=2)
    after = digests(bench)
    assert {k: v for k, v in after.items() if k in before} == before

    line = run(tmp_path, "throwaway.ring", seconds=0.5)
    assert line["correct"]
    assert set(line["metrics"]) == {"throwaway.ring_requests", "setup_s"}
    assert line["metrics"]["throwaway.ring_requests"]["value"] == line["attempted"]
    line = run(tmp_path, "throwaway.sum", seconds=0.2, devices=[CPU, CPU])
    assert line["correct"] and line["device"]["count"] == 2
    assert line["checks"] == {"sum_mismatches": {"value": 0, "limit": 0}}
    assert "data" in line["seconds"]["setup_stages"]
    assert set(line["metrics"]) == {"throwaway.sum_requests", "setup_s"}


def test_an_unknown_kind_is_refused(tmp_path):
    copy_tree(tmp_path)
    (tmp_path / "benchmark" / "configs" / "throwaway.json").write_text("{}")
    (tmp_path / "benchmark" / "traffic" / "throwaway.json").write_text(
        json.dumps({"kind": "../lib/harness"}))
    add_throwaway_cell(tmp_path, "throwaway.cell", "throwaway", "throwaway")
    with pytest.raises(ValueError, match="unknown traffic kind"):
        run(tmp_path, "throwaway.cell", seconds=0.1)


def command(args, cwd, **env):
    return subprocess.run([sys.executable, "benchmark/run.py", *args], capture_output=True,
                          text=True, cwd=cwd, env={**os.environ, **env}, timeout=300)


ARGS = ["--workload", "kzg.commit-2p20", "--seed", str(SEED), "--seconds", "1", "--trace", "0"]


def test_command_refuses_without_a_card():
    proc = command(ARGS, ROOT, CUDA_VISIBLE_DEVICES="")
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_command_refuses_with_only_the_benchmark(tmp_path):
    copy_tree(tmp_path)
    proc = command(ARGS, tmp_path, PYTHONPATH="")
    assert proc.returncode != 0 and proc.stdout.strip() == ""

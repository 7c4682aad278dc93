"""BENCHMARK.json against the contract's static rules, and the imports of
what runs on the chip: no module named jax, jaxlib, flax or simpleworks_tpu
(whole top-level names; the port's name begins with the last), and a plain
reference that imports nothing of the program."""

import json
import re
import subprocess
import sys

from benchmark.lib import harness
from benchmark.tests.tiny import ROOT

SPEC = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys_and_limits():
    assert list(SPEC) == ["command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"]
    assert SPEC["command"] == ["python3", "benchmark/run.py"] and SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    cells = len(SPEC["workloads"])
    assert 1 <= cells <= 24 and 1 <= len(SPEC["configs"]) <= 24
    # a full check of 24 cells fits its 43,200 seconds
    assert (2 + 14 * 24) * (SPEC["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_entries():
    configs = {c["name"]: c for c in SPEC["configs"]}
    for c in SPEC["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert c["file"].startswith("benchmark/") and (ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"]
    used = set()
    for w in SPEC["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert (ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").is_file()
        used.add(w["config"])
    assert used == set(configs)
    four = sum(w["chips"] == 4 for w in SPEC["workloads"])
    assert four <= max(1, len(SPEC["workloads"]) // 4)
    pairs = [(w["config"], w["traffic"]) for w in SPEC["workloads"]]
    assert len(pairs) == len(set(pairs))
    metrics = SPEC["end_to_end"] + SPEC["per_layer"]
    names = [m["name"] for m in metrics]
    assert len(names) == len(set(names))
    cells = {w["name"] for w in SPEC["workloads"]}
    for m in SPEC["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in SPEC["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert LINE.match(m["layer"]) and m["moves"] in {e["name"] for e in SPEC["end_to_end"]}
    for m in metrics:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert (ROOT / "benchmark" / "metrics" / f"{m['name']}.py").is_file()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_mix_names_a_kind_that_is_there():
    for w in SPEC["workloads"]:
        mix = json.loads((ROOT / "benchmark" / "traffic" / f"{w['traffic']}.json").read_text())
        assert NAME.match(mix["kind"])
        assert (ROOT / "benchmark" / "kinds" / f"{mix['kind']}.py").is_file()


def test_every_cell_reports_what_the_contract_asks():
    for w in SPEC["workloads"]:
        e2e = {m["name"] for m in harness.metrics_for(SPEC, w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = harness.metrics_for(SPEC, w["name"], True)
        assert layer and all(m["moves"] in e2e for m in layer)


PROBE = """
import sys
sys.path.insert(0, {root!r})
import importlib, importlib.util, pathlib
root = pathlib.Path({root!r})
for name in ("benchmark.reference.field", "benchmark.reference.g1", "benchmark.reference.kzg",
             "benchmark.reference.transcript", "benchmark.reference.marlin"):
    importlib.import_module(name)
program = sorted(m for m in sys.modules if m.split(".")[0] == "simpleworks_tpu_torch")
for name in ("benchmark.run", "benchmark.control", "benchmark.lib.harness",
             "benchmark.lib.generator", "benchmark.lib.faults", "benchmark.lib.trace",
             "benchmark.lib.work", "benchmark.lib.seeds"):
    importlib.import_module(name)
for path in sorted((root / "benchmark" / "metrics").glob("*.py")) + sorted(
        (root / "benchmark" / "kinds").glob("*.py")):
    spec = importlib.util.spec_from_file_location("m_" + path.stem.replace(".", "_"), path)
    spec.loader.exec_module(importlib.util.module_from_spec(spec))
import simpleworks_tpu_torch.kzg.kzg10, simpleworks_tpu_torch.marlin
from benchmark.lib.harness import forbidden_modules
print(program, forbidden_modules())
"""


def test_no_jax_and_a_reference_apart_from_the_program():
    proc = subprocess.run([sys.executable, "-c", PROBE.format(root=str(ROOT))],
                          capture_output=True, text=True, cwd=ROOT, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "[] []"


def test_forbidden_names_are_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "simpleworks_tpu_torch_probe", sys)
    assert "simpleworks_tpu_torch_probe" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jaxlib.probe", sys)
    assert "jaxlib.probe" in harness.forbidden_modules()

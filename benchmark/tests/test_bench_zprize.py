"""The ``commit_zprize`` kind on the CPU at a tiny size: a cell of it added
beside the tiny cells of ``tiny.py`` (width 2^10, a ring of 2, an SRS of
degree 1023), correct as it stands and not correct under the control's
fault; and its two-level reference against the one-level one of the
``commit`` kind."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark.lib import faults, harness
from benchmark.reference import field, kzg, kzg_wide
from benchmark.tests.tiny import tiny_tree

SEED = 2**31 + 2026
CELL, REAL = "tiny.commit-2p26", "kzg.commit-2p26"
MIX = {"width": 1 << 10, "ring": 2}


@pytest.fixture(scope="module")
def tree(tmp_path_factory):
    root = tiny_tree(tmp_path_factory.mktemp("bench"))
    bench = root / "benchmark"
    spec = json.loads((root / "BENCHMARK.json").read_text())
    (bench / "configs" / "tiny-zprize.json").write_text(
        json.dumps({"name": "tiny-zprize", "max_degree": (1 << 10) - 1, "reduced": []}))
    spec["configs"].append({"name": "tiny-zprize", "source": "a test's tiny size",
                            "file": "benchmark/configs/tiny-zprize.json", "reduced": [],
                            "why": "CPU tests"})
    real = next(c for c in spec["workloads"] if c["name"] == REAL)
    mix = json.loads((bench / "traffic" / f"{real['traffic']}.json").read_text())
    mix.update(MIX)
    (bench / "traffic" / "tiny-commit-2p26.json").write_text(json.dumps(mix))
    spec["workloads"].append({"name": CELL, "config": "tiny-zprize",
                              "traffic": "tiny-commit-2p26", "chips": 1, "why": "CPU tests"})
    for metric in spec["end_to_end"] + spec["per_layer"]:
        if REAL in metric.get("workloads", []):
            metric["workloads"].append(CELL)
    (root / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return root


def run(tree, hook=None):
    return harness.run_cell(tree, CELL, SEED, 0.5, False, [torch.device("cpu")],
                            time.perf_counter(), stage_hook=hook)


def test_the_kind_is_correct(tree):
    line = run(tree)
    assert line["correct"], line
    assert line["failed"] == 0 and line["compared"]["commits"] == line["attempted"] >= 1
    assert line["checks"] == {"commit_mismatches": {"value": 0, "limit": 0},
                              "srs_power_mismatches": {"value": 0, "limit": 0}}
    assert {"commit_ms", "setup_s"} <= set(line["metrics"])


def test_the_control_is_not_correct(tree):
    undo = []
    try:
        line = run(tree, faults.planter("top_window", undo))
    finally:
        while undo:
            undo.pop()()
    assert line["correct"] is False
    assert all(check["value"] > check["limit"] for check in line["checks"].values())


@pytest.mark.parametrize("block", [32, 1 << 10, kzg_wide.BLOCK])
def test_two_levels_equal_one(block):
    rng = np.random.default_rng(block)
    limbs = rng.integers(0, 1 << 16, (16, MIX["width"])).astype(np.int32)
    limbs[15] %= field.R >> 240
    tau, _ = kzg.setup_scalars(lambda: int(rng.integers(0, 1 << 63)))
    assert kzg_wide.mont_eval(limbs, kzg_wide.power_tables(tau, MIX["width"], block)) == \
        kzg.mont_eval(limbs, kzg.power_limbs(tau, MIX["width"]))
    assert kzg_wide.commitment(limbs, kzg_wide.power_tables(tau, MIX["width"], block)) == \
        kzg.commitment(limbs, kzg.power_limbs(tau, MIX["width"]))

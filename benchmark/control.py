#!/usr/bin/env python3
"""Readings for the limits of ``correct``: runs one cell over several seeds
in one process, each run with an optional fault planted under the timed
path (benchmark/lib/faults.py), and prints one JSON line a run with the
numbers compared.  Not run by the benchmark's own runs.

    python3 benchmark/control.py --workload <name> --seconds <s> \\
        --fault none|top_window|half_batch|answer_altered --seeds <n> [<n> ...]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--fault", default="none")
    parser.add_argument("--seeds", type=int, nargs="+", required=True)
    args = parser.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark.run import RUN_ENV

    os.environ.update(RUN_ENV)
    import torch

    from benchmark.lib import faults, harness

    if args.fault != "none" and args.fault not in faults.FAULTS:
        parser.error(f"--fault: one of none, {', '.join(faults.FAULTS)}")
    chips = harness.cell_of(harness.load_spec(ROOT), args.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", k) for k in range(chips)]
    undo = []
    plant = faults.planter(args.fault, undo)
    for seed in args.seeds:
        started = time.perf_counter()
        try:
            result = harness.run_cell(ROOT, args.workload, seed, args.seconds, False,
                                      devices, started, stage_hook=plant)
        finally:
            while undo:
                undo.pop()()
        torch.cuda.empty_cache()
        print(json.dumps({"workload": args.workload, "fault": args.fault, "seed": seed,
                          "correct": result["correct"], "attempted": result["attempted"],
                          "checks": result["checks"], "compared": result["compared"],
                          "metrics": result["metrics"],
                          "wall_s": time.perf_counter() - started}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

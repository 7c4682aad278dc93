#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, from the root of a checkout:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Sets up (inputs and weights from the seed, the cell's shapes warmed),
measures a closed loop for ``--seconds``, judges what the window produced
against the plain reference, and prints one JSON line last on standard
output; the numbers compared, each beside its limit, are the last lines on
standard error.  Exits non-zero, printing no result, without a CUDA card,
when the program cannot be imported, or when JAX or the JAX package is
loaded in the process.
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
#: the bytecode of every module a run imports, PyTorch's among them, kept in
#: the checkout, so that only the first run in a checkout compiles it: an
#: installation without bytecode, or a process told not to write it,
#: compiles every module anew (about 3 s of each run's set-up on an H100
#: machine)
sys.pycache_prefix = str(ROOT / "benchmark" / ".cache" / "pycache")
sys.dont_write_bytecode = False
#: the run writes no SRS or proving-key checkpoint; caches stay in the checkout
RUN_ENV = {
    "SWTPU_SRS_DISK_CACHE": "0",
    "SWTPU_PK_DISK_CACHE": "0",
    "TORCH_EXTENSIONS_DIR": str(ROOT / "benchmark" / ".cache" / "torch_extensions"),
    "TRITON_CACHE_DIR": str(ROOT / "benchmark" / ".cache" / "triton"),
}


def main(argv: list[str]) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    os.environ.update(RUN_ENV)
    sys.path.insert(0, str(ROOT))

    import torch

    from benchmark.lib import harness

    cell = harness.cell_of(harness.load_spec(ROOT), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"needs {cell['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    devices = [torch.device("cuda", k) for k in range(cell["chips"])]
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds, bool(args.trace),
                              devices, STARTED)
    leaked = harness.forbidden_modules()
    if leaked:
        print(f"forbidden modules loaded in the run's process: {leaked}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"check {name}: {check['value']} (limit {check['limit']})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""One run of one cell: find the cell's configuration, traffic mix and
metric readers by the names in ``BENCHMARK.json``, set up, measure a closed
loop for the window, read the metrics, judge the outputs against the plain
reference, and build the result line.

Everything a cell needs is found by name: the configuration at the
``file`` its entry gives (and, for a configuration that builds inputs with
code, the ``.py`` file beside it), the mix at ``benchmark/traffic/<traffic>
.json``, the mix's kind of request at ``benchmark/kinds/<kind>.py``, and
each metric's reader at ``benchmark/metrics/<metric>.py``, a module with
``read(run) -> float | None``.  A cell runs on as many devices as its
``chips`` gives."""

from __future__ import annotations

import json
import subprocess
import sys
import time
from contextlib import ExitStack, nullcontext
from dataclasses import dataclass, field
from pathlib import Path

from . import generator
from .trace import WINDOW_SPAN, TraceSummary, summarize

#: top-level module names that may not be loaded in a run's process
FORBIDDEN_MODULES = ("jax", "jaxlib", "flax", "simpleworks_tpu")


@dataclass
class Run:
    """What a metric's reader sees of one run."""

    workload: str
    config: dict
    mix: dict
    setup_s: float
    window_s: float = 0.0
    attempted: int = 0
    completed: int = 0
    failed: int = 0
    latencies_s: list[float] = field(default_factory=list)
    launches: dict[str, int] = field(default_factory=dict)   # per kernel name, in the window
    spans: dict[str, float] = field(default_factory=dict)    # per program span, in the window
    trace: TraceSummary | None = None
    clock_mhz: float | None = None


def load_spec(root: Path) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell_of(spec: dict, workload: str) -> dict:
    for cell in spec["workloads"]:
        if cell["name"] == workload:
            return cell
    raise KeyError(f"no workload {workload!r} in BENCHMARK.json")


def config_of(spec: dict, root: Path, name: str) -> dict:
    for entry in spec["configs"]:
        if entry["name"] == name:
            config = json.loads((root / entry["file"]).read_text())
            config["_file"] = entry["file"]
            config.setdefault("name", name)
            return config
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def mix_of(root: Path, traffic: str) -> dict:
    return json.loads((root / "benchmark" / "traffic" / f"{traffic}.json").read_text())


def metrics_for(spec: dict, workload: str, trace: bool) -> list[dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer ones: a
    metric with a ``workloads`` list where it lists the cell; an end-to-end
    one without it everywhere; a per-layer one without it wherever the
    metric it moves is reported."""
    e2e = [m for m in spec["end_to_end"]
           if workload in m.get("workloads", [workload])]
    if not trace:
        return e2e
    reported = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (workload in m["workloads"] if "workloads" in m else m["moves"] in reported)]


def reader(root: Path, metric: str):
    path = root / "benchmark" / "metrics" / f"{metric}.py"
    return generator.load_module(path, f"bench_metric_{metric.replace('.', '_')}").read


def forbidden_modules() -> list[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN_MODULES)


def smi(query: str) -> str | None:
    """One nvidia-smi reading of the first card, or None."""
    try:
        out = subprocess.run(["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    lines = out.stdout.strip().splitlines()
    return lines[0].strip() if out.returncode == 0 and lines else None


def _clock_mhz() -> float | None:
    text = smi("clocks.max.sm")
    try:
        return float(text.split()[0]) if text else None
    except ValueError:
        return None


def run_cell(root: Path, workload: str, seed: int, seconds: float, trace: bool, devices,
             started: float, stage_hook=None) -> dict:
    """One run over ``devices`` (the cell's chips, one device each);
    returns the result line's object.  ``started`` is the host clock at the
    start of the process; ``stage_hook``, when given, is called as
    ``stage_hook(stage, traffic)`` before set-up (``"setup"``) and after it
    (``"window"``): the control and the fault tests plant their faults
    there."""
    import torch

    devices = list(devices)
    spec = load_spec(root)
    cell = cell_of(spec, workload)
    config = config_of(spec, root, cell["config"])
    mix = mix_of(root, cell["traffic"])
    on_card = devices[0].type == "cuda"

    def sync():
        for d in devices:
            torch.cuda.synchronize(d)

    traffic = generator.make(config, mix, seed, devices, root)
    traffic.marks.append(("start", started))
    traffic.mark("imports")
    if on_card:
        for d in devices:
            torch.empty(1, device=d)
        sync()
        traffic.mark("card start")
    if stage_hook is not None:
        stage_hook("setup", traffic)
    traffic.setup()
    if stage_hook is not None:
        stage_hook("window", traffic)
    traffic.warm()
    if on_card:
        sync()
    traffic.mark("warm-up")

    run = Run(workload=workload, config=config, mix=mix, setup_s=traffic.marks[-1][1] - started)
    stages = {name: t - traffic.marks[k - 1][1] for k, (name, t) in enumerate(traffic.marks) if k}
    records, failures = [], []
    before = traffic.snapshot()
    request_span = f"request.{mix['kind']}"
    with ExitStack() as window:
        if trace:
            window.enter_context(traffic.traced())
            activities = [torch.profiler.ProfilerActivity.CPU]
            if on_card:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = window.enter_context(torch.profiler.profile(activities=activities))
            window.enter_context(torch.profiler.record_function(WINDOW_SPAN))
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            start = time.perf_counter()
            try:
                with torch.profiler.record_function(request_span) if trace else nullcontext():
                    out = traffic.request(i)
            except Exception as exc:  # a failed request counts against the run
                failures.append(f"request {i}: {type(exc).__name__}: {exc}")
            else:
                run.latencies_s.append(time.perf_counter() - start)
                records.append(traffic.record(i, out))
            i += 1
        if on_card:
            sync()
        run.window_s = time.perf_counter() - t0
    after = traffic.snapshot()
    run.attempted, run.completed, run.failed = i, len(records), len(failures)
    run.launches = {k: v - before["launches"].get(k, 0) for k, v in after["launches"].items()}
    run.spans = {k: v - before["spans"].get(k, 0.0) for k, v in after["spans"].items()}
    peak = max(torch.cuda.max_memory_allocated(d) for d in devices) if on_card else 0
    closed = time.perf_counter()
    if trace:
        run.trace = summarize(prof, traffic.span_labels | {request_span}, len(devices))
        del prof
        run.clock_mhz = _clock_mhz() if on_card else None
    traced = time.perf_counter()

    metrics = {}
    for metric in metrics_for(spec, workload, trace):
        value = reader(root, metric["name"])(run)
        if value is not None:
            metrics[metric["name"]] = {"value": value, "unit": metric["unit"]}

    checks = traffic.check(records)
    checked = time.perf_counter()
    compared = checks.pop("_compared", {})
    correct = not failures and run.completed > 0 and all(v <= lim for v, lim in checks.values())
    result = {"correct": correct, "attempted": run.attempted, "failed": run.failed,
              "metrics": metrics,
              "device": {"platform": "gpu" if on_card else devices[0].type,
                         "kind": torch.cuda.get_device_name(devices[0]) if on_card else "cpu",
                         "count": len(devices), "memory_peak_bytes": peak}}
    if trace and run.trace is not None:
        result["device"]["busy_s"] = run.trace.busy_s
        result["device"]["window_s"] = run.trace.window_s
        result["breakdown"] = run.trace.breakdown()
    result["power_limit"] = smi("name,power.limit") if on_card else None
    result["compared"] = compared
    result["seconds"] = {"setup": run.setup_s, "setup_stages": stages, "window": run.window_s,
                         "trace": traced - closed, "check": checked - traced}
    result["failures"] = failures[:5]
    result["checks"] = {name: {"value": v, "limit": lim} for name, (v, lim) in checks.items()}
    return result

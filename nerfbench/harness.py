"""The general part of a run: find the cell's files by name, check for the
card, hand the cell to its driver, read the per-layer metrics from the
trace, check that no JAX module was loaded, and print the result.

Everything that belongs to one configuration, one cell, one kind of window
or one per-layer metric sits in a file of its own:

- ``configs/<config>.json``: the configuration as it is run;
- ``workloads/<cell>.json``: the cell's configuration, traffic and limits;
- ``traffic/<traffic>.json``: a traffic mix's parameters and its driver's kind;
- ``drivers/<kind>.py``: the window of that kind (``run(ctx)``);
- ``metrics/<metric>.py``: one reader per per-layer metric (``read(trace)``).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from types import ModuleType
from typing import Any, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
# top-level module names that may not be loaded in a run's process
FORBIDDEN = ("jax", "jaxlib", "flax", "emernerf_tpu")


class BenchError(RuntimeError):
    """A run that cannot give a result (no card, a missing file)."""


@dataclasses.dataclass
class Check:
    """One number compared with the reference, and its limit: the run is
    correct only where every number is at most its limit."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit


@dataclasses.dataclass
class Ctx:
    """What a driver gets: the cell, its configuration, the run's arguments."""

    name: str
    workload: Dict[str, Any]
    config: Dict[str, Any]
    seed: int
    seconds: float
    trace: bool
    device: Any
    t_start: float


@dataclasses.dataclass
class Outcome:
    """What a driver returns."""

    attempted: int
    failed: int
    end_to_end: Dict[str, float]  # this cell's end-to-end metrics but setup_s
    t_window: float  # perf_counter at the window's start: set-up ends there
    memory_peak_bytes: int
    checks: List[Check]
    reasons: List[str]  # why the run is not correct, besides the checks
    trace: Optional[Dict[str, Any]] = None  # what the metric readers read
    busy_s: float = 0.0
    window_s: float = 0.0
    breakdown: Optional[Dict[str, list]] = None


def pin_caches(root: str) -> None:
    """Every build and kernel cache at a fixed directory inside the checkout."""
    build = os.path.join(root, "build", "nerfbench")
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(build, "triton"))
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", os.path.join(build, "torch_extensions"))
    os.environ.setdefault("USE_FLAX", "0")


def load_json(*parts) -> Dict[str, Any]:
    path = os.path.join(HERE, *parts)
    if not os.path.isfile(path):
        raise BenchError(f"no file {os.path.relpath(path, os.path.dirname(HERE))}")
    with open(path) as f:
        return json.load(f)


def load_module(*parts) -> ModuleType:
    """A module of the benchmark's folders by its file name, which may hold
    dots and dashes (``metrics/k1_fwd_roofline_pct.eval.py``)."""
    path = os.path.join(HERE, *parts)
    if not os.path.isfile(path):
        raise BenchError(f"no file {os.path.relpath(path, os.path.dirname(HERE))}")
    name = "nerfbench._by_name." + "_".join(parts).replace(".", "_").replace("-", "_")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def load_workload(cell: str) -> Dict[str, Any]:
    """The cell's file (configuration, traffic, limits) over its traffic
    mix's parameters (``traffic/<traffic>.json``)."""
    own = load_json("workloads", f"{cell}.json")
    return {**load_json("traffic", f"{own['traffic']}.json"), **own}


def manifest() -> Dict[str, Any]:
    return load_json(os.pardir, "BENCHMARK.json")


def cell_metrics(bench: Dict[str, Any], cell: str, group: str) -> List[Dict[str, Any]]:
    """The metrics of ``group`` (end_to_end or per_layer) that ``cell`` reports."""
    return [m for m in bench[group] if "workloads" not in m or cell in m["workloads"]]


def forbidden_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def device_info(device, count: int = 1) -> Dict[str, Any]:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": count, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": count,
            "memory_peak_bytes": 0}


def check_chip(chips: int):
    """The card, or BenchError: a run never falls back to the CPU."""
    import torch

    if not torch.cuda.is_available():
        raise BenchError("torch.cuda.is_available() is False: this benchmark runs on the card")
    if torch.cuda.device_count() < chips:
        raise BenchError(f"the cell asks for {chips} cards, torch.cuda.device_count() = "
                         f"{torch.cuda.device_count()}")
    return torch.device("cuda", 0)


def run(args, t_start: float, device=None, out=sys.stdout, err=sys.stderr) -> int:
    """One run; returns the exit code.  ``device`` None looks for the card
    (the benchmark's runs); the tests pass the CPU."""
    try:
        bench = manifest()
        workload = load_workload(args.workload)
        config = load_json("configs", f"{workload['config']}.json")
        entry = [w for w in bench["workloads"] if w["name"] == args.workload]
        if not entry:
            raise BenchError(f"BENCHMARK.json has no cell {args.workload!r}")
        if entry[0]["traffic"] != workload["traffic"]:
            raise BenchError(f"{args.workload}: BENCHMARK.json names the traffic "
                             f"{entry[0]['traffic']!r}, its file {workload['traffic']!r}")
        if device is None:
            device = check_chip(int(entry[0]["chips"]))
        driver = load_module("drivers", f"{workload['kind']}.py")
        e2e = cell_metrics(bench, args.workload, "end_to_end")
        layer = cell_metrics(bench, args.workload, "per_layer") if args.trace else []
        readers = {m["name"]: load_module("metrics", f"{m['name']}.py") for m in layer}
    except BenchError as e:
        print(f"nerfbench: {e}", file=err)
        return 3
    import torch

    torch.set_num_threads(1)
    print(f"nerfbench: host cpus {len(os.sched_getaffinity(0))}, load {os.getloadavg()}",
          file=err)
    ctx = Ctx(args.workload, workload, config, int(args.seed), float(args.seconds),
              bool(args.trace), device, t_start)
    res: Outcome = driver.run(ctx)
    bad = forbidden_modules()
    if bad:
        print(f"nerfbench: modules loaded in this process that a run may not load: {bad}",
              file=err)
        return 4
    setup_s = res.t_window - t_start
    values = dict(res.end_to_end, setup_s=setup_s)
    metrics = {}
    if args.trace:
        for m in layer:
            v = readers[m["name"]].read(res.trace)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        for m in e2e:
            if m["name"] in values:
                metrics[m["name"]] = {"value": float(values[m["name"]]), "unit": m["unit"]}
    correct = not res.reasons and all(c.ok for c in res.checks)
    dev = device_info(device)
    dev["memory_peak_bytes"] = int(res.memory_peak_bytes)
    if args.trace:
        dev["busy_s"], dev["window_s"] = float(res.busy_s), float(res.window_s)
    line = {"correct": correct, "attempted": int(res.attempted), "failed": int(res.failed),
            "metrics": metrics, "device": dev}
    if args.trace and res.breakdown is not None:
        line["breakdown"] = res.breakdown
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit} for c in res.checks}
    for r in res.reasons:
        print(f"nerfbench: not correct: {r}", file=err)
    for c in res.checks:
        print(f"compared {c.name} = {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'OVER'}", file=err)
    err.flush()
    print(json.dumps(line), file=out)
    out.flush()
    return 0

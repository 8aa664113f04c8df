"""What every cell shares: finding a cell's files by name, the run's
context, the card's description, and the assembly of the result line.

A cell is ``workloads/<name>.json`` (its configuration, traffic kind,
parameters and why); its configuration is ``configs/<config>.json``; its
traffic kind is the module ``traffic/<traffic>.py``; each per-layer metric
is ``metrics/<metric>.py`` with a ``read(counters, trace)`` that returns a
number or None. Which metrics a cell reports is read from the root's
BENCHMARK.json: an end-to-end metric whose ``workloads`` name the cell (or
that has none), a per-layer metric whose ``workloads`` name it (or, with
none, whose ``moves`` the cell reports).
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import math
import os
import sys
from typing import Any, Dict, List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "isdf_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, here: str = HERE) -> Dict[str, Any]:
    """The cell ``name``'s workload file with its configuration's file
    (``"config_file"``) and the metrics BENCHMARK.json gives it
    (``"end_to_end"``, ``"per_layer"``: lists of entries)."""
    cell = load_json(os.path.join(here, "workloads", name + ".json"))
    cell["name"] = name
    cell["config_file"] = load_json(
        os.path.join(here, "configs", cell["config"] + ".json"))
    bench = load_json(os.path.join(os.path.dirname(here), "BENCHMARK.json"))
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    names = {m["name"] for m in e2e}
    cell["end_to_end"] = e2e
    cell["per_layer"] = [m for m in bench["per_layer"]
                         if (name in m["workloads"] if "workloads" in m
                             else m["moves"] in names)]
    chips = [w["chips"] for w in bench["workloads"] if w["name"] == name]
    cell["chips"] = chips[0] if chips else 1
    return cell


def metric_module(name: str, here: str = HERE):
    """The module metrics/<name>.py (a metric's name may hold dots)."""
    path = os.path.join(here, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def metric_reader(name: str, here: str = HERE):
    """The ``read(counters, trace)`` of metrics/<name>.py."""
    return metric_module(name, here).read


@dataclasses.dataclass
class Ctx:
    """One run: its arguments, its cell, where it may write, the device it
    measures and, for the CPU rehearsals, shrunken sizes."""
    seed: int
    seconds: float
    trace: bool
    cell: Dict[str, Any]
    device: Any
    t_process: float
    scratch: str
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    def limit(self, name: str) -> float:
        return float(self.cell["limits"][name])

    @property
    def params(self) -> Dict[str, Any]:
        p = dict(self.cell.get("params", {}))
        p.update(self.overrides.get("params", {}))
        return p

    def config(self) -> dict:
        """The configuration as run: the config file's reference-schema
        dict with the cell's and the rehearsal's overrides applied."""
        cfg = json.loads(json.dumps(self.cell["config_file"]["config"]))
        for key, val in self.overrides.get("config", {}).items():
            d = cfg
            *path, last = key.split(".")
            for k in path:
                d = d.setdefault(k, {})
            d[last] = val
        return cfg

    def note(self, line: str):
        print(line, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Outcome:
    """What a traffic kind returns: its end-to-end numbers, the counters
    the per-layer readers read, the comparisons that decide ``correct``
    ([name, value, limit]), requests attempted and failed, the device peak
    and the trace."""
    e2e: Dict[str, float]
    counters: Dict[str, Any]
    checks: List[List[Any]]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Any = None
    chips: int = 1


def device_info(device, chips: int) -> Dict[str, Any]:
    import torch
    if getattr(device, "type", "cpu") == "cuda":
        kind = torch.cuda.get_device_name(device)
        platform = "gpu"
    else:
        kind, platform = "cpu", "cpu"
    return {"platform": platform, "kind": kind, "count": chips}


def loaded_forbidden() -> List[str]:
    """Modules of JAX or of the JAX package in this process, compared by
    whole top-level names."""
    return sorted({m for m in sys.modules
                   if m.split(".")[0] in FORBIDDEN})


def percentile(values, p: float) -> float:
    """The p-th percentile (0-100) by linear interpolation."""
    xs = sorted(values)
    if not xs:
        return math.nan
    k = (len(xs) - 1) * p / 100.0
    lo, hi = math.floor(k), math.ceil(k)
    return xs[lo] + (xs[hi] - xs[lo]) * (k - lo)


def correct_of(checks) -> bool:
    return all(math.isfinite(v) and v <= lim for _, v, lim in checks)


def result_line(ctx: Ctx, out: Outcome) -> Dict[str, Any]:
    """The result object: end-to-end metrics with --trace 0, per-layer ones
    (those whose readers find something) with --trace 1; the compared
    numbers last."""
    metrics = {}
    if ctx.trace:
        for m in ctx.cell["per_layer"]:
            v = metric_reader(m["name"])(out.counters, out.trace)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in ctx.cell["end_to_end"]:
            if m["name"] in out.e2e:
                metrics[m["name"]] = {"value": out.e2e[m["name"]],
                                      "unit": m["unit"]}
    dev = device_info(ctx.device, out.chips)
    dev["memory_peak_bytes"] = int(out.memory_peak_bytes)
    res = {"correct": correct_of(out.checks), "attempted": out.attempted,
           "failed": out.failed, "metrics": metrics, "device": dev}
    if ctx.trace and out.trace is not None:
        dev["busy_s"] = out.trace.busy_s()
        dev["window_s"] = out.trace.window_s
        res["breakdown"] = {"device_ops": out.trace.top_ops(),
                            "idle_gaps": out.trace.idle_gaps()}
    res["compared"] = {n: {"value": v, "limit": lim}
                       for n, v, lim in out.checks}
    return res

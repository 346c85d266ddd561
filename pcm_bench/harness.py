"""Finds a cell's files by name, runs its traffic driver once and builds the
result line.

A cell ``<cell>`` is ``workloads/<cell>.json``: its ``config`` names
``configs/<config>.json`` and its ``traffic`` names the driver module
``traffic/<traffic>.py``, whose ``run(ctx)`` returns a `Run`. The metrics a
cell reports are those of `BENCHMARK.json` that apply to it: with
``--trace 0`` its end-to-end metrics, which the driver measures, and with
``--trace 1`` its per-layer metrics, each read from the run's record by
``layer_metrics/<metric>.py``'s ``read(record)`` (None: nothing to read,
and the metric is left out).
"""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "pcm_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux; 0 where /proc says nothing)."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return max(0.0, uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return 0.0


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> Dict:
    return load_json(REPO / "BENCHMARK.json")


def load_cell(name: str) -> Dict:
    """The workload file of ``name``, with its configuration under ``config_spec``."""
    spec = load_json(HERE / "workloads" / f"{name}.json")
    spec["name"] = name
    spec["config_spec"] = load_json(HERE / "configs" / f"{spec['config']}.json")
    return spec


def cell_metrics(bench: Dict, cell: str, trace: bool) -> List[Dict]:
    """The metrics of ``bench`` that ``cell`` reports in a run of that kind."""
    group = bench["per_layer"] if trace else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(metric: str) -> Callable[[Dict], Optional[float]]:
    """``read`` of ``layer_metrics/<metric>.py``."""
    path = HERE / "layer_metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(f"pcm_bench_layer_{metric}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def loaded_forbidden() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    `FORBIDDEN`, compared whole: ``pcm_tpu_torch`` is not ``pcm_tpu``."""
    return sorted(n for n in list(sys.modules) if n.split(".")[0] in FORBIDDEN)


@dataclasses.dataclass
class Context:
    """What a traffic driver gets. ``t0``: the process's start on the
    ``time.perf_counter`` clock. ``device`` is ``cuda`` for the CLI; the CPU
    tests pass ``cpu`` with TINY sizes in ``spec``. ``options``: ``fault``
    (a fault planted under the timed path), set by the calibration and the
    tests, never by the CLI."""

    spec: Dict
    seed: int
    seconds: float
    trace: bool
    device: Any
    t0: float
    tmp: str
    options: Dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Run:
    """A driver's result: the end-to-end metrics by name, the record the
    per-layer readers read, the numbers compared with their limits
    (``{name: (value, limit)}``), requests or steps attempted and failed,
    the window's peak device memory and the trace's summary (or None)."""

    end_to_end: Dict[str, float]
    record: Dict
    checks: Dict[str, tuple]
    attempted: int
    failed: int
    memory_peak_bytes: int
    trace: Optional[Dict] = None


def correct(checks: Dict[str, tuple]) -> bool:
    """Every number finite and at or under its limit (and some compared)."""
    return bool(checks) and all(
        v is not None and math.isfinite(v) and v <= lim for v, lim in checks.values())


def run_cell(name: str, seed: int, seconds: float, trace: bool, device, tmp: str,
             t0: Optional[float] = None, spec: Optional[Dict] = None,
             options: Optional[Dict] = None) -> Run:
    """One run of cell ``name`` (``spec``: its workload, by default read from file)."""
    spec = spec or load_cell(name)
    driver = importlib.import_module(f"pcm_bench.traffic.{spec['traffic']}")
    ctx = Context(spec=spec, seed=seed, seconds=seconds, trace=trace, device=device,
                  t0=time.perf_counter() if t0 is None else t0, tmp=tmp,
                  options=dict(options or {}))
    return driver.run(ctx)


def result_line(bench: Dict, cell: str, run: Run, trace: bool, device_info: Dict) -> Dict:
    """The JSON object of the last line; ``checks`` last."""
    metrics = {}
    for m in cell_metrics(bench, cell, trace):
        if trace:
            value = reader(m["name"])(run.record)
        else:
            value = run.end_to_end[m["name"]]
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = dict(device_info, memory_peak_bytes=int(run.memory_peak_bytes))
    if trace and run.trace is not None:
        device.update(busy_s=run.trace["busy_s"], window_s=run.trace["window_s"])
    out = {"correct": correct(run.checks), "attempted": run.attempted, "failed": run.failed,
           "metrics": metrics, "device": device}
    if trace and run.trace is not None:
        out["breakdown"] = run.trace["breakdown"]
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in run.checks.items()}
    return out

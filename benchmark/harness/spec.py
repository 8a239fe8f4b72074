"""Cells, configurations, traffic mixes and metrics, found by name.

``BENCHMARK.json`` at the root of the checkout lists them; each lives in a
file of its own under ``benchmark/``:

- a configuration: the file that ``BENCHMARK.json`` names for it;
- a cell: ``workloads/<name>.json`` (its limits and anything else of its own);
- a traffic mix: ``traffic/<name>.json`` (its parameters and its driver);
- a per-layer metric, or an end-to-end one that the run does not time
  itself: ``metrics/<name>.py`` (its reader).

A later cell or metric is added by adding files and entries: nothing here
names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                     # the checkout


@dataclasses.dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names, read."""

    name: str
    chips: int
    config_name: str
    config: Dict            # the configuration's file
    traffic_name: str
    traffic: Dict           # traffic/<name>.json
    workload: Dict          # workloads/<name>.json
    end_to_end: List[Dict]  # BENCHMARK.json's end-to-end entries this cell reports
    per_layer: List[Dict]   # and its per-layer ones


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``; a KeyError names the cells there are."""
    spec = benchmark_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=load_json(root / configs[w["config"]]["file"]),
        traffic_name=w["traffic"],
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        workload=load_json(bench / "workloads" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
    )


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py`` loaded as a module (a name may hold dots)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + name.replace(".", "_").replace("-", "_"), path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def read_per_layer(cell: Cell, run, root: Path = ROOT) -> Dict[str, Dict]:
    """Each per-layer metric of ``cell`` that its reader finds something to
    read for in ``run``, as ``{name: {"value", "unit"}}``."""
    out = {}
    for m in cell.per_layer:
        value: Optional[float] = metric_reader(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def traced_end_to_end(cell: Cell) -> bool:
    """Whether one of ``cell``'s end-to-end metrics is read from the
    device's trace."""
    return any(m["source"] == "device_trace" for m in cell.end_to_end)


def read_end_to_end(cell: Cell, run, root: Path = ROOT) -> Dict[str, Dict]:
    """``cell``'s end-to-end metrics as ``{name: {"value", "unit"}}``: those
    the window timed itself from ``run["window"]``, the others from their
    readers, left out where a reader finds nothing (no device on the CPU)."""
    out = {}
    for m in cell.end_to_end:
        if m["name"] in run["window"]:
            value: Optional[float] = run["window"][m["name"]]
        else:
            value = metric_reader(m["name"], root).read(run)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out

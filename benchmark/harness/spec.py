"""Cells, configurations, traffic mixes and metrics, found by name.

``BENCHMARK.json`` at the root of the checkout lists them; each lives in a
file of its own under ``benchmark/``:

- a configuration: the file that ``BENCHMARK.json`` names for it;
- a cell: ``workloads/<name>.json`` (its limits and anything else of its own);
- a traffic mix: ``traffic/<name>.json`` (its parameters and its driver);
- a per-layer metric, or an end-to-end one that the run does not time
  itself: ``metrics/<name>.py`` (its reader);
- a model type (a configuration's ``models.coarse.type``): its plug-in
  ``models/<type>.py`` (its kernels' launch counters, the plain stand-ins
  that count them on the CPU, its seeding, its operations and bytes) and its
  plain field ``reference/fields/<type>.py``.

A later cell, metric or model type is added by adding files and entries:
nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Callable, Dict, List, NamedTuple, Optional

HERE = Path(__file__).resolve().parent.parent          # benchmark/
ROOT = HERE.parent                                     # the checkout


class ModelType(NamedTuple):
    """What the benchmark knows of one model type, from its two files."""

    name: str
    plugin: ModuleType      # models/<name>.py
    field: Callable         # reference/fields/<name>.py's ``field``


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
    model: ModelType        # the type of the configuration's fields
    root: Path              # the checkout it was found in


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: Path = ROOT) -> Dict:
    return load_json(root / "BENCHMARK.json")


def _applies(metric: Dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def find_cell(name: str, root: Path = ROOT) -> Cell:
    """The cell called ``name``; a KeyError names the cells there are, a
    FileNotFoundError the files its model type lacks."""
    spec = benchmark_spec(root)
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; there are {sorted(cells)}")
    w = cells[name]
    configs = {c["name"]: c for c in spec["configs"]}
    bench = root / "benchmark"
    config = load_json(root / configs[w["config"]]["file"])
    return Cell(
        name=name,
        chips=int(w["chips"]),
        config_name=w["config"],
        config=config,
        traffic_name=w["traffic"],
        traffic=load_json(bench / "traffic" / f"{w['traffic']}.json"),
        workload=load_json(bench / "workloads" / f"{name}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _applies(m, name)],
        per_layer=[m for m in spec["per_layer"] if _applies(m, name)],
        model=model_type(config["models"]["coarse"]["type"], root),
        root=root,
    )


def _load(path: Path, module_name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(module_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str, root: Path = ROOT) -> ModuleType:
    """``metrics/<name>.py`` loaded as a module (a name may hold dots)."""
    path = root / "benchmark" / "metrics" / f"{name}.py"
    return _load(path, "benchmark_metric_" + name.replace(".", "_").replace("-", "_"))


def model_type_files(name: str, root: Path = ROOT) -> List[Path]:
    """The two files of model type ``name``: its plug-in and its plain field."""
    bench = root / "benchmark"
    return [bench / "models" / f"{name}.py", bench / "reference" / "fields" / f"{name}.py"]


def model_type(name: str, root: Path = ROOT) -> ModelType:
    """Model type ``name`` from its plug-in and its plain field. The field
    is loaded inside the reference's package, whose helpers it imports
    relatively; a FileNotFoundError names both files where one is missing."""
    plugin_path, field_path = model_type_files(name, root)
    if not (plugin_path.is_file() and field_path.is_file()):
        raise FileNotFoundError(
            f"model type {name!r} needs both {plugin_path} and {field_path}")
    plugin = _load(plugin_path, "benchmark_model_" + name)
    field = _load(field_path, "benchmark.reference.fields." + name).field
    return ModelType(name, plugin, field)


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

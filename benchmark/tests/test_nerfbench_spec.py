"""Every cell, configuration, traffic mix and metric of BENCHMARK.json
resolves to its file by name; the file keeps to the benchmark's contract;
a cell and a metric added as new files only are picked up."""

import json
import re
import shutil

import pytest

from benchmark.harness import spec
from benchmark.harness.spec import ROOT

BENCH = spec.benchmark_spec()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_paths():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_keep_to_the_contract(section):
    entries = BENCH[section]
    assert entries and len({e["name"] for e in entries}) == len(entries)
    for e in entries:
        extra = {"workloads"} if section in ("end_to_end", "per_layer") else set()
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | extra, e["name"]
        assert NAME.match(e["name"]), e["name"]
        for text in ("why", "layer", "source"):
            if text in e:
                assert 1 <= len(e[text]) <= 200 and "\n" not in e[text] and "\t" not in e[text]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        if section == "end_to_end":
            assert e["source"] in ("host_clock", "device_trace")
            assert 0.01 <= e["bound"] <= 0.25


def test_every_cell_reports_what_it_must():
    cells = [w["name"] for w in BENCH["workloads"]]
    for name in cells:
        cell = spec.find_cell(name)
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2, name
        assert cell.per_layer, name
        for m in cell.per_layer:
            assert m["moves"] in e2e, (name, m["name"])
        assert cell.chips == 1
        assert cell.traffic["driver"] in ("train", "render")
        assert cell.workload["limits"], name
    assert [w["name"] for w in BENCH["workloads"]] == [
        "flex_train", "flex_render", "paper_train", "paper_render"]


def test_configurations_resolve_by_name():
    for c in BENCH["configs"]:
        path = ROOT / c["file"]
        assert c["file"].startswith("benchmark/") and path.is_file()
        config = spec.load_json(path)
        assert config["name"] == c["name"] and config["source"] == c["source"]
        assert config["reduced"] == c["reduced"]
        for key in c["reduced"]:
            assert NAME.match(key) and not key.endswith(("_dim", "_rank"))
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics_resolve_to_their_readers():
    for m in BENCH["per_layer"]:
        reader = spec.metric_reader(m["name"])
        assert (reader.UNIT, reader.LAYER, reader.MOVES, reader.SOURCE) == (
            m["unit"], m["layer"], m["moves"], m["source"]), m["name"]
        assert callable(reader.read)
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_device_trace_end_to_end_metrics_resolve_to_their_readers():
    for m in BENCH["end_to_end"]:
        if m["source"] == "device_trace":
            reader = spec.metric_reader(m["name"])
            assert (reader.UNIT, reader.SOURCE) == (m["unit"], m["source"]), m["name"]
            assert callable(reader.read)


def test_a_cell_and_a_metric_added_as_files_are_found(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    bench["workloads"].append({"name": "dummy_cell", "config": "flex_4x128",
                               "traffic": "dummy_mix", "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "dummy.metric", "unit": "%", "better": "higher",
                               "source": "program_counter", "layer": "device",
                               "moves": "train_rays_per_s", "workloads": ["dummy_cell"]})
    bench["end_to_end"][0]["workloads"].append("dummy_cell")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    (tmp_path / "benchmark/workloads/dummy_cell.json").write_text(
        json.dumps({"limits": {"grad_gap": 1.0}}))
    (tmp_path / "benchmark/traffic/dummy_mix.json").write_text(
        json.dumps({"driver": "train", "views": 1, "height": 8, "width": 8, "pose_seed": 0,
                    "steps_per_call": 1, "checked_steps": 1}))
    (tmp_path / "benchmark/metrics/dummy.metric.py").write_text(
        "UNIT = '%'\nLAYER = 'device'\nMOVES = 'train_rays_per_s'\n"
        "SOURCE = 'program_counter'\n\ndef read(info):\n    return 42.0 + info['x']\n")
    cell = spec.find_cell("dummy_cell", root=tmp_path)
    assert cell.traffic["views"] == 1 and cell.workload["limits"] == {"grad_gap": 1.0}
    assert [m["name"] for m in cell.per_layer] == ["dummy.metric"]
    assert {m["name"] for m in cell.end_to_end} == {"train_rays_per_s", "setup_s"}
    got = spec.read_per_layer(cell, {"x": 1.0}, root=tmp_path)
    assert got == {"dummy.metric": {"value": 43.0, "unit": "%"}}
    with pytest.raises(KeyError):
        spec.find_cell("no_such_cell", root=tmp_path)

"""The result line's schema, from whole runs of the harness on the CPU."""

import json
import subprocess
import sys

import pytest

from benchmark.harness.spec import ROOT, benchmark_spec
from cpu_runs import cpu_run

BENCH = benchmark_spec()


@pytest.mark.parametrize("workload", ["flex_train", "flex_render"])
@pytest.mark.parametrize("trace", [False, True], ids=["trace0", "trace1"])
def test_result_schema(workload, trace):
    res = cpu_run(workload, trace=trace)
    assert list(res)[-1] == "checks"
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert ("breakdown" in res) == trace
    assert isinstance(res["correct"], bool) and res["attempted"] > 0 and res["failed"] == 0
    dev = res["device"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(dev)
    assert ("busy_s" in dev and "window_s" in dev) == trace
    # On the CPU no device operation runs: an end-to-end metric read from
    # the device's trace finds nothing there.
    e2e = {m["name"] for m in BENCH["end_to_end"]
           if workload in m.get("workloads", [workload]) and m["source"] == "host_clock"}
    per_layer = {m["name"] for m in BENCH["per_layer"] if workload in m["workloads"]}
    if trace:
        # On the CPU no device operation runs: only the host-clock reader reads.
        assert set(res["metrics"]) <= per_layer and res["metrics"]
        assert len(res["breakdown"]["device_ops"]) <= 10
        assert len(res["breakdown"]["idle_gaps"]) <= 10
    else:
        assert set(res["metrics"]) == e2e
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    for c in res["checks"].values():
        assert set(c) == {"value", "limit", "ok"}
    json.dumps(res)


def test_no_card_no_result(tmp_path):
    """Without CUDA the command prints no result and fails; so it does in a
    directory holding only BENCHMARK.json and the benchmark."""
    import shutil

    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    for cwd in (ROOT, tmp_path):
        proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "flex_train",
                               "--seed", "3000000001", "--seconds", "1", "--trace", "0"],
                              cwd=cwd, capture_output=True, text=True, timeout=300,
                              env={"PATH": "/usr/bin:/bin", "CUDA_VISIBLE_DEVICES": ""})
        assert proc.returncode != 0
        assert "{" not in proc.stdout

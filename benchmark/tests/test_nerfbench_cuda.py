"""On the card: each cell's command runs end to end and is correct, and the
control at the cells' own sizes is not. ``python -m pytest benchmark/tests
-m cuda -q`` from the root of the checkout; skips without a card."""

import json
import subprocess
import sys

import pytest

from benchmark.harness import spec
from benchmark.harness.spec import ROOT

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in spec.benchmark_spec()["workloads"]]


def need_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.parametrize("workload", CELLS)
def test_the_cell_runs_and_is_correct(workload):
    need_card()
    proc = subprocess.run([sys.executable, "benchmark/run.py", "--workload", workload,
                           "--seed", "2147483909", "--seconds", "2", "--trace", "0"],
                          cwd=ROOT, capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-4000:]
    res = json.loads(proc.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu" and res["device"]["count"] == 1


@pytest.mark.parametrize("workload", CELLS)
def test_the_control_fails_at_the_cells_size(workload):
    need_card()
    from benchmark.calibrate import reading

    cell = spec.find_cell(workload)
    got = reading(cell, 2147483911, "cuda", control="fp8")
    limits = cell.workload["limits"]
    assert any(got[k] > limit for k, limit in limits.items()), (got, limits)

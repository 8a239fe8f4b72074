"""The comparison fails what it must: each fault a cell can have, planted
under the timed path, and the control (the reference one precision below
the configuration's in the system's place) make ``correct`` false, where a
sound run of the same size is correct. On the CPU at a size a test can
hold; the readings at the cells' own sizes are made on the card by
``benchmark/calibrate.py``."""

import pytest

from benchmark.drivers import train
from benchmark.drivers.render import RenderRun
from benchmark.harness import spec
from cpu_runs import SIZES, counted_plain_kernels, cpu_run

SEED = 2147483701


@pytest.mark.parametrize("workload,fault", [
    ("flex_train", ""), ("flex_train", "unchanged"), ("flex_train", "half_batch"),
    ("paper_train", ""), ("paper_train", "unchanged"), ("paper_train", "half_batch"),
    ("flex_render", ""), ("flex_render", "altered"),
    ("paper_render", ""), ("paper_render", "altered"),
])
def test_a_fault_makes_the_run_incorrect(workload, fault):
    res = cpu_run(workload, seed=SEED, faults=(fault,) if fault else ())
    assert res["correct"] is (not fault), res["checks"]


@pytest.mark.parametrize("workload", ["flex_train", "paper_train"])
def test_the_training_control_is_incorrect(workload):
    cell = spec.find_cell(workload)
    got = train.reference_readings(cell, SEED, "cpu", "fp8", SIZES["train"])
    limits = cell.workload["limits"]
    assert any(got[k] > limit for k, limit in limits.items()), (got, limits)


@pytest.mark.parametrize("workload", ["flex_render", "paper_render"])
def test_the_render_control_is_incorrect(workload):
    cell = spec.find_cell(workload)
    run = RenderRun(cell, SEED, "cpu", sizes=SIZES["render"])
    with counted_plain_kernels():
        run.setup()
        run.warm_up()
        run.window(0, frames=4)
    run.release()
    got = run.readings("fp8")
    limits = cell.workload["limits"]
    assert any(got[k] > limit for k, limit in limits.items()), (got, limits)

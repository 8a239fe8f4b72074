"""Runs of the harness on the CPU at a size a test can hold: the kernels'
plain versions stand in for the kernels, and their launch counters are
counted around those plain versions, as on the card around the kernels."""

import contextlib
import importlib
import time

import pytest

from benchmark import run as bench_run
from benchmark.harness import spec

SIZES = {
    "train": dict(rays=64, samples=16, views=2, height=16, width=16, steps_per_call=3),
    "render": dict(samples=16, image=16, warmup_frames=1, traced_frames=2, checked_frames=2),
}


@contextlib.contextmanager
def counted_plain_kernels(root=spec.ROOT):
    """Count launches on the plain versions the CPU runs: those that each
    model type's plug-in under ``root`` names (``CPU_STANDINS``)."""
    mp = pytest.MonkeyPatch()

    def counting(module, name, holder, attr):
        plain = getattr(module, name)

        def wrapped(*a, **k):
            setattr(holder, attr, getattr(holder, attr) + 1)
            return plain(*a, **k)

        mp.setattr(module, name, wrapped)

    for path in sorted((root / "benchmark" / "models").glob("*.py")):
        plugin = spec.model_type(path.stem, root).plugin
        for module_name, plain, wrapper, attr in plugin.CPU_STANDINS:
            module = importlib.import_module(module_name)
            counting(module, plain, getattr(module, wrapper), attr)
    try:
        yield
    finally:
        mp.undo()


def cpu_run(workload: str, seed: int = 2147483659, trace: bool = False, faults=(),
            seconds: float = 0.3, root=spec.ROOT) -> dict:
    cell = spec.find_cell(workload, root)
    with counted_plain_kernels(root):
        return bench_run.run_cell(cell, seed, seconds, trace, "cpu", time.time(), faults=faults,
                                  sizes=SIZES[cell.traffic["driver"]], log=lambda *_: None)

"""Runs of the harness on the CPU at a size a test can hold: the kernels'
plain versions stand in for the kernels, and their launch counters are
counted around those plain versions, as on the card around the kernels."""

import contextlib
import time

import pytest

from benchmark import run as bench_run
from benchmark.harness import spec

SIZES = {
    "train": dict(rays=64, samples=16, views=2, height=16, width=16, steps_per_call=3),
    "render": dict(samples=16, image=16, warmup_frames=1, traced_frames=2, checked_frames=2),
}


@contextlib.contextmanager
def counted_plain_kernels():
    """Count launches on the plain versions the CPU runs."""
    from nerf_tpu_torch.kernels import flex_train, mlp_t, paper_t, paper_train

    mp = pytest.MonkeyPatch()

    def counting(module, name, holder, attr):
        plain = getattr(module, name)

        def wrapped(*a, **k):
            setattr(holder, attr, getattr(holder, attr) + 1)
            return plain(*a, **k)

        mp.setattr(module, name, wrapped)

    counting(flex_train, "flex_train_plain_fwd", flex_train.fused_flex_mlp_train, "fwd_launches")
    counting(flex_train, "flex_train_plain_bwd", flex_train.fused_flex_mlp_train, "bwd_launches")
    counting(paper_train, "paper_train_plain_fwd", paper_train.fused_paper_mlp_train,
             "fwd_launches")
    counting(paper_train, "paper_train_plain_bwd", paper_train.fused_paper_mlp_train,
             "bwd_launches")
    counting(mlp_t, "mlp_t_plain", mlp_t.fused_mlp_t, "launches")
    counting(paper_t, "paper_t_plain", paper_t.fused_paper_mlp_t, "launches")
    try:
        yield
    finally:
        mp.undo()


def cpu_run(workload: str, seed: int = 2147483659, trace: bool = False, faults=(),
            seconds: float = 0.3) -> dict:
    cell = spec.find_cell(workload)
    with counted_plain_kernels():
        return bench_run.run_cell(cell, seed, seconds, trace, "cpu", time.time(), faults=faults,
                                  sizes=SIZES[cell.traffic["driver"]], log=lambda *_: None)

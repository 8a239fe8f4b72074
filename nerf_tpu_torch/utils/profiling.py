"""Profiling and timing helpers (port of ``nerf_tpu/utils/profiling.py``).

``trace(logdir)`` records the enclosed region with ``torch.profiler`` (host
and, on a CUDA build with a card, device activity) and writes it as a Chrome
trace into ``logdir``, which Perfetto and ``chrome://tracing`` open;
``annotate(name)`` marks a named sub-region in it; ``time_fn`` gives
steady-state seconds per call, waiting for the device where the JAX helper
blocks on its result.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Tuple

import torch


def _synchronize() -> None:
    """Wait for the card's queued work, where there is a card."""
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextlib.contextmanager
def trace(logdir: str):
    """Record the enclosed region and write ``logdir/trace_<pid>_<ns>.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        _synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named sub-region inside an active trace (shows up in the timeline)."""
    return torch.profiler.record_function(name)


def time_fn(fn: Callable, *args, warmup: int = 2, reps: int = 10) -> Tuple[float, object]:
    """Steady-state seconds per call of ``fn(*args)`` after ``warmup`` calls,
    the device's queued work waited for before and after the timed calls.

    Returns (seconds_per_call, last_output).
    """
    out = None
    for _ in range(warmup):
        out = fn(*args)
    _synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    _synchronize()
    return (time.perf_counter() - t0) / reps, out

"""nerf_tpu_torch.utils.profiling: the JAX helpers' interface on torch.profiler.

``trace(logdir)`` writes a Chrome trace of the region into ``logdir`` with
each ``annotate`` span in it; ``time_fn`` returns (seconds a call, the last
output) as the JAX ``time_fn`` does, calling the function warmup + reps
times.
"""

import json
import os

import torch

from nerf_tpu.utils import profiling as jprofiling
from nerf_tpu_torch.utils import profiling


def test_trace_writes_a_chrome_trace_with_the_spans(tmp_path):
    logdir = tmp_path / "trace"
    with profiling.trace(str(logdir)):
        with profiling.annotate("render_chunk"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = os.listdir(logdir)
    assert len(files) == 1 and files[0].endswith(".json")
    events = json.loads((logdir / files[0]).read_text())["traceEvents"]
    assert any(e.get("name") == "render_chunk" for e in events)


def test_time_fn_counts_calls_and_returns_the_last_output():
    calls = []

    def fn(x):
        calls.append(1)
        return x + len(calls)

    secs, out = profiling.time_fn(fn, torch.zeros(()), warmup=3, reps=4)
    assert len(calls) == 7 and float(out) == 7.0 and secs >= 0.0
    jcalls = []

    def jfn(x):
        jcalls.append(1)
        return x + len(jcalls)

    jsecs, jout = jprofiling.time_fn(jfn, 0.0, warmup=3, reps=4)
    assert len(jcalls) == len(calls) and float(jout) == float(out)

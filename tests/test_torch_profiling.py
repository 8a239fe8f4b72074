"""nerf_tpu_torch.utils.profiling: the port's spans.

``annotate`` opens a ``record_function`` range only under an active
profiler, where the Chrome trace holds it as a ``user_annotation`` event;
with none active it hands back one shared null context and opens nothing.
"""

import json

import torch

from nerf_tpu_torch.utils import profiling


def chrome_spans(prof, tmp_path):
    """The ``user_annotation`` events of a finished profile as (name, start,
    end) in microseconds, by start."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = json.loads(path.read_text())["traceEvents"]
    return sorted(((e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"),
                  key=lambda s: s[1])


def test_annotate_without_a_profiler_opens_nothing(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) opened with no profiler active")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert not torch._C._autograd._profiler_enabled()
    first = profiling.annotate(profiling.TRAIN_DRAW)
    assert first is profiling.annotate(profiling.SERVE_REQUEST)
    with first:
        with profiling.annotate(profiling.RENDER_FIELD):
            torch.ones(4).add_(1)


def test_annotate_under_a_profiler_records_nested_spans(tmp_path):
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with profiling.annotate(profiling.RENDER_IMAGE):
            with profiling.annotate(profiling.RENDER_FIELD):
                torch.ones(64, 64) @ torch.ones(64, 64)
    (outer, o0, o1), (inner, i0, i1) = chrome_spans(prof, tmp_path)
    assert (outer, inner) == (profiling.RENDER_IMAGE, profiling.RENDER_FIELD)
    assert o0 <= i0 and i1 <= o1 + 1e-3
    # Once the profiler stops, a span costs nothing again.
    assert profiling.annotate("after") is profiling.annotate(profiling.TRAIN_UPDATE)


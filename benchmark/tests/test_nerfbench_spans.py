"""The card's time and idle by the port's spans (``harness/spans.py``) on
hand-made Chrome traces with spans, launches and correlations, and the
phase tool (``phases.py``) on the CPU."""

import pytest

from benchmark import phases
from benchmark.harness import spans as sp
from benchmark.harness import spec
from benchmark.harness import trace as tr
from benchmark.tests.cpu_runs import SIZES, counted_plain_kernels
from nerf_tpu_torch.utils import profiling as p

MAIN, AUTOGRAD = 1, 2


def chrome(window, spans, ops, launches):
    """``spans``: (name, start, end) on the main thread; ``ops``: (name,
    start, end, correlation); ``launches``: (correlation, time, thread)."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": tr.WINDOW_SPAN, "tid": MAIN,
           "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "user_annotation", "name": n, "tid": MAIN, "ts": s, "dur": e - s}
           for n, s, e in spans]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": e - s,
            "args": {"correlation": c}} for n, s, e, c in ops]
    ev += [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": tid, "ts": t,
            "dur": 1, "args": {"correlation": c}} for c, t, tid in launches]
    return {"traceEvents": ev}


def two_steps():
    """Two 1000-us steps: draw 0-100, forward 100-400 (fields 150-250 and
    300-350), backward 400-800, update 800-950, then 50 us of the loop's
    own; #8's forward and backward kernels and Adam's, one left unmatched."""
    spans, ops, launches = [], [], []
    for k in range(2):
        t = 1000 * k
        spans += [(p.TRAIN_DRAW, t, t + 100), (p.TRAIN_FORWARD, t + 100, t + 400),
                  (p.RENDER_FIELD, t + 150, t + 250), (p.RENDER_FIELD, t + 300, t + 350),
                  (p.TRAIN_BACKWARD, t + 400, t + 800), (p.TRAIN_UPDATE, t + 800, t + 950)]
        c = 10 * k
        ops += [("randint", t + 20, t + 40, c),
                ("train_fwd_kernel<true>", t + 200, t + 260, c + 1),
                ("train_fwd_kernel<true>", t + 320, t + 380, c + 2),
                ("train_bwd_wgrad_kernel<true>", t + 500, t + 700, c + 3),
                ("multi_tensor_apply_kernel", t + 850, t + 900, c + 4)]
        launches += [(c, t + 10, MAIN), (c + 1, t + 190, MAIN), (c + 2, t + 310, MAIN),
                     (c + 3, t + 450, AUTOGRAD), (c + 4, t + 840, MAIN)]
    ops.append(("stack", 1960, 1970, 99))            # launched after the last step
    launches.append((99, 1955, MAIN))
    ops.append(("copy", 1975, 1980, 98))             # no launch in the trace
    return sp.from_chrome(chrome((0, 2000), spans, ops, launches))


def test_a_step_splits_by_phase():
    ph = two_steps()
    parts = phases.parts(ph, "train")
    got = sp.split(ph, parts, 2)
    assert got[p.TRAIN_DRAW]["device_ms"] == pytest.approx(0.020)
    assert got[p.TRAIN_DRAW]["idle_ms"] == pytest.approx(0.080)
    assert got[p.RENDER_FIELD]["device_ms"] == pytest.approx(0.120)
    assert got[p.RENDER_FIELD]["launches"] == 2
    assert got[f"{p.TRAIN_FORWARD} less {p.RENDER_FIELD}"]["device_ms"] == 0
    # The backward's kernel was launched from autograd's thread, inside the span.
    assert got[p.TRAIN_BACKWARD]["device_ms"] == pytest.approx(0.200)
    assert got[p.TRAIN_BACKWARD]["ops"] == [["train_bwd_wgrad_kernel<true>",
                                             pytest.approx(0.200), 1.0]]
    assert got[p.TRAIN_UPDATE]["device_ms"] == pytest.approx(0.050)
    assert got["outside"]["launches"] == 0.5 and got["unmatched"]["launches"] == 0.5
    # The phases and what is outside them hold every idle microsecond.
    idle = sum(part["idle_ms"] for name, part in got.items() if name != "unmatched")
    assert idle == pytest.approx(1e3 * sum(e - s for s, e in tr.idle_gaps(ph.trace)) / 1e6 / 2)
    # Every launch falls in one part: the parts partition the window.
    launched = sum(part["launches"] for part in got.values())
    assert launched == len(ph.ops) / 2


def test_a_frame_splits_into_service_renderer_and_fields():
    spans = [(p.SERVE_REQUEST, 0, 1000), (p.RENDER_IMAGE, 50, 900),
             (p.RENDER_FIELD, 100, 400), (p.RENDER_FIELD, 500, 700)]
    ops = [("mlp_t_kernel<true>", 150, 450, 1), ("mlp_t_kernel<true>", 510, 760, 2),
           ("radixSortKVInPlace", 460, 500, 3), ("cumprod", 760, 800, 4),
           ("copy_u8", 910, 950, 5)]
    launches = [(1, 120, MAIN), (2, 505, MAIN), (3, 410, MAIN), (4, 720, MAIN),
                (5, 905, MAIN)]
    ph = sp.from_chrome(chrome((0, 1000), spans, ops, launches))
    got = sp.split(ph, phases.parts(ph, "render"), 1)
    renderer = got[f"{p.RENDER_IMAGE} less {p.RENDER_FIELD}"]
    assert renderer["device_ms"] == pytest.approx(0.080) and renderer["launches"] == 2
    assert got[p.RENDER_FIELD]["device_ms"] == pytest.approx(0.550)
    service = got[f"{p.SERVE_REQUEST} less {p.RENDER_IMAGE}"]
    # The service's stretches: 0-50 and 900-1000, busy 910-950 alone.
    assert service["device_ms"] == pytest.approx(0.040)
    assert service["idle_ms"] == pytest.approx(0.110)
    assert got["outside"] == {"device_ms": 0, "idle_ms": 0, "launches": 0, "ops": []}


def test_a_trace_without_spans_has_everything_outside():
    ph = sp.from_chrome(chrome((0, 100), [], [("k", 10, 30, 1)], [(1, 5, MAIN)]))
    got = sp.split(ph, phases.parts(ph, "train"), 1)
    assert got["outside"]["device_ms"] == pytest.approx(0.020)
    assert all(got[name]["launches"] == 0 for name in phases.parts(ph, "train"))


@pytest.mark.parametrize("a,b,minus,inter", [
    ([(0, 10)], [(2, 3), (5, 7)], [(0, 2), (3, 5), (7, 10)], [(2, 3), (5, 7)]),
    ([(0, 4), (6, 10)], [(3, 7)], [(0, 3), (7, 10)], [(3, 4), (6, 7)]),
    ([(0, 4)], [(4, 8)], [(0, 4)], []),
    ([(2, 3)], [(0, 10)], [], [(2, 3)]),
])
def test_stretch_arithmetic(a, b, minus, inter):
    assert sp.minus(a, b) == minus and sp.intersect(a, b) == inter
    assert sp.union(a + b) == sp.union(minus + b)


@pytest.mark.parametrize("workload", ["flex_train", "paper_render"])
def test_the_phase_tool_finds_the_ports_spans_on_the_cpu(workload):
    cell = spec.find_cell(workload)
    with counted_plain_kernels():
        got = phases.phase_split(cell, 2147483659, 0.2, "cpu",
                                 sizes=SIZES[cell.traffic["driver"]], log=lambda *_: None)
    parts = got["parts"]
    for name, part in parts.items():
        if name not in ("outside", "unmatched"):
            assert part["idle_ms"] > 0 and part["device_ms"] == 0, name
    # On the CPU the window is idle through: the parts hold all but the
    # loop's own bookkeeping.
    assert parts["outside"]["idle_ms"] < 0.2 * got["window_ms"]

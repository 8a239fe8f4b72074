"""Trace reduction on a hand-made Chrome trace: the busy union, the idle
gaps and what the host did in them, launches, kernel time by name, and the
per-layer readers on it."""

import pytest

from benchmark.harness import trace as tr
from benchmark.harness.spec import metric_reader, ROOT, load_json


def chrome(window, device, host):
    ev = [{"ph": "X", "cat": "user_annotation", "name": "bench.window",
           "ts": window[0], "dur": window[1] - window[0]}]
    ev += [{"ph": "X", "cat": "kernel", "name": n, "ts": s, "dur": e - s} for n, s, e in device]
    ev += [{"ph": "X", "cat": "cpu_op", "name": n, "ts": s, "dur": e - s} for n, s, e in host]
    ev.append({"ph": "i", "cat": "kernel", "name": "instant", "ts": 5})
    return {"traceEvents": ev}


def test_busy_union_gaps_and_host():
    t = tr.from_chrome(chrome(
        (0, 100),
        [("void (anonymous namespace)::train_fwd_kernel<true>(float const*)", 10, 30),
         ("k2", 20, 40),                   # overlaps the first: counted once
         ("k3", 60, 70), ("k4", 95, 120)],  # the last is cut at the window's end
        [("aten::sort", 40, 55), ("aten::index", 42, 50), ("aten::mul", 72, 94)]))
    assert tr.busy_s(t) == pytest.approx((30 + 10 + 5) / 1e6)
    assert tr.idle_gaps(t) == [(0, 10), (40, 60), (70, 95)]
    assert tr.device_launches(t) == 4
    idle = dict(tr.idle_by_host(t))
    # (0, 10): nothing on the host; (40, 60): the outermost op at 50 is the
    # sort; (70, 95): the mul.
    assert idle == pytest.approx({"python between operators": 10e-6, "aten::sort": 20e-6,
                                  "aten::mul": 25e-6})
    names = dict(tr.top_device_ops(t))
    assert names["train_fwd_kernel<true>"] == pytest.approx(20e-6)
    assert tr.matching_seconds(t, [r"\btrain_fwd(_one)?_kernel"]) == (pytest.approx(20e-6), 1)
    assert tr.short_name("void at::native::reduce_kernel<512, 1, at::native::R<a(b)> >(x, y)") \
        == "at::native::reduce_kernel<512, 1, at::native::R<a(b)> >"


def test_a_trace_needs_its_window():
    with pytest.raises(ValueError):
        tr.from_chrome({"traceEvents": []})


def test_readers_on_a_traced_step():
    config = load_json(ROOT / "benchmark/configs/flex_4x128.json")
    # Two steps, each 1 ms of #8 and 1 ms of other work in a 10 ms window.
    dev = []
    for step in range(2):
        t0 = step * 5000
        dev += [("train_fwd_kernel<true>", t0, t0 + 400),
                ("train_bwd_act_one_kernel<true>", t0 + 400, t0 + 1000),
                ("at::native::elementwise", t0 + 1000, t0 + 2000)]
    t = tr.from_chrome(chrome((0, 10000), dev, []))
    info = {"config": config, "traced": {"trace": t, "steps": 2},
            "window": {"seconds": 2.0, "steps": 200}}
    assert metric_reader("launches_per_step.train").read(info) == 3
    assert metric_reader("device_idle_pct.train").read(info) == pytest.approx(60.0)
    # 2 ms busy a traced step against 10 ms a step in the untraced window.
    assert metric_reader("untraced_busy_pct.train").read(info) == pytest.approx(20.0)
    assert metric_reader("device_idle_pct.render").read(info) is None
    # 1024 x (64 + 128) points of forward + backward at 989 TFLOP/s, over 1 ms.
    least = 2 * (83_840 + 74_048 + 83_840) * 1024 * 192 / 989e12
    assert metric_reader("flex_train_roofline").read(info) == pytest.approx(100 * least / 1e-3)
    assert metric_reader("paper_train_roofline").read(info) is None   # another model
    assert metric_reader("mlp_t_roofline").read(info) is None         # not a frame
    mfu = 100 * 3 * 2 * 83_840 * 1024 * 192 * 200 / 2.0 / 989e12
    assert metric_reader("train_mfu_pct").read(info) == pytest.approx(mfu)
    assert metric_reader("render_mfu_pct").read(info) is None
    # The flagship's cell: the device's 2 ms a traced step, end to end, and
    # the same readings under the names that move it.
    assert metric_reader("train_step_device_ms").read(info) == pytest.approx(2.0)
    assert metric_reader("launches_per_step.flex_train").read(info) == 3
    assert metric_reader("device_idle_pct.flex_train").read(info) == pytest.approx(60.0)
    assert metric_reader("untraced_busy_pct.flex_train").read(info) == pytest.approx(20.0)
    device_mfu = 100 * 3 * 2 * 83_840 * 1024 * 192 / 2e-3 / 989e12
    assert metric_reader("train_mfu_pct.flex_train").read(info) == pytest.approx(device_mfu)
    info["window"]["train_rays_per_s"] = 102_400.0
    assert metric_reader("host_rays_per_s.flex_train").read(info) == 102_400.0


def test_a_reader_with_no_kernel_to_read_returns_nothing():
    config = load_json(ROOT / "benchmark/configs/flex_4x128.json")
    t = tr.from_chrome(chrome((0, 1000), [("other", 0, 10)], []))
    info = {"config": config, "traced": {"trace": t, "frames": 1},
            "window": {"seconds": 1.0, "frames": 10}}
    assert metric_reader("mlp_t_roofline").read(info) is None
    assert metric_reader("untraced_busy_pct.train").read(info) is None   # frames, not steps
    empty = tr.from_chrome(chrome((0, 1000), [], []))
    info["traced"]["trace"] = empty
    assert metric_reader("device_idle_pct.render").read(info) is None
    assert metric_reader("train_step_device_ms").read(info) is None       # frames, not steps

"""A profiled window and what it reduces to: the device's busy time (the
union of its operations' intervals), its idle gaps and what the host was
doing in them, the operations that took the most time, and kernel time by
name.

The window is recorded with ``torch.profiler`` (CPU and CUDA activity) and
read from its Chrome trace, whose format names every event's category:
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` run on the device, ``cpu_op``
are the host's operators, and the benchmark's own span ``bench.window``
(``user_annotation``) marks the window on the host's clock, which the device
events share.
"""

from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from collections import defaultdict
from typing import Callable, Dict, List, NamedTuple, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW_SPAN = "bench.window"
BETWEEN_OPS = "python between operators"


class Event(NamedTuple):
    name: str
    start: float   # microseconds
    end: float


class Trace(NamedTuple):
    """The events of a profiled window, in microseconds."""

    window: Tuple[float, float]
    device: List[Event]     # kernels, copies and sets, by start
    host: List[Event]       # cpu_op events, by start

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e6


def from_chrome(trace: Dict) -> Trace:
    """A ``Trace`` from a parsed Chrome trace holding one ``bench.window``."""
    device, host, window = [], [], None
    for e in trace.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        ev = Event(e.get("name", ""), float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            device.append(ev)
        elif cat == "cpu_op":
            host.append(ev)
        elif e.get("name") == WINDOW_SPAN and cat == "user_annotation":
            window = (ev.start, ev.end)
    if window is None:
        raise ValueError(f"the trace has no {WINDOW_SPAN!r} span")
    device.sort(key=lambda ev: ev.start)
    host.sort(key=lambda ev: ev.start)
    return Trace(window, device, host)


def record(fn: Callable[[], None], cuda: bool) -> Trace:
    """``fn()`` under the profiler inside the ``bench.window`` span; ``fn``
    ends by waiting for the device. The Chrome trace goes through a file in
    ``TMPDIR``, removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=acts) as prof:
        with record_function(WINDOW_SPAN):
            fn()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="bench_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return from_chrome(json.load(f))
    finally:
        with contextlib.suppress(FileNotFoundError):
            os.unlink(path)


def busy_intervals(trace: Trace) -> List[Tuple[float, float]]:
    """The union of the device events' intervals, clipped to the window."""
    lo, hi = trace.window
    merged: List[List[float]] = []
    for ev in trace.device:
        s, e = max(ev.start, lo), min(ev.end, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_s(trace: Trace) -> float:
    return sum(e - s for s, e in busy_intervals(trace)) / 1e6


def idle_gaps(trace: Trace) -> List[Tuple[float, float]]:
    """The window's stretches in which no device operation ran."""
    lo, hi = trace.window
    gaps, t = [], lo
    for s, e in busy_intervals(trace):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


def idle_by_host(trace: Trace, top: int = 10) -> List[List]:
    """Idle seconds grouped by the outermost host operator running at each
    gap's middle (``python between operators`` where none ran), most first."""
    sums: Dict[str, float] = defaultdict(float)
    active: List[Event] = []
    k = 0
    for s, e in idle_gaps(trace):
        mid = 0.5 * (s + e)
        while k < len(trace.host) and trace.host[k].start <= mid:
            if trace.host[k].end >= mid:
                active.append(trace.host[k])
            k += 1
        active = [ev for ev in active if ev.end >= mid]
        name = (max(active, key=lambda ev: ev.end - ev.start).name if active
                else BETWEEN_OPS)
        sums[name] += (e - s) / 1e6
    return [[k_, v] for k_, v in sorted(sums.items(), key=lambda kv: -kv[1])[:top]]


def short_name(name: str) -> str:
    """A device operation's name without its return type, namespace of
    internal linkage and argument list."""
    name = re.sub(r"^void ", "", name)
    name = name.replace("(anonymous namespace)::", "")
    depth, cut = 0, len(name)
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            cut = i
            break
    return name[:cut][:120]


def device_seconds_by_name(trace: Trace) -> Dict[str, float]:
    """Device seconds of each operation name (shortened) in the window."""
    lo, hi = trace.window
    out: Dict[str, float] = defaultdict(float)
    for ev in trace.device:
        s, e = max(ev.start, lo), min(ev.end, hi)
        if e > s:
            out[short_name(ev.name)] += (e - s) / 1e6
    return dict(out)


def top_device_ops(trace: Trace, top: int = 10) -> List[List]:
    by_name = device_seconds_by_name(trace)
    return [[k, v] for k, v in sorted(by_name.items(), key=lambda kv: -kv[1])[:top]]


def matching_seconds(trace: Trace, patterns) -> Tuple[float, int]:
    """Device seconds and count of the operations whose full names match any
    of the regular expressions ``patterns``."""
    rx = [re.compile(p) for p in patterns]
    lo, hi = trace.window
    total, count = 0.0, 0
    for ev in trace.device:
        if any(r.search(ev.name) for r in rx):
            s, e = max(ev.start, lo), min(ev.end, hi)
            if e > s:
                total += (e - s) / 1e6
                count += 1
    return total, count


def device_launches(trace: Trace) -> int:
    """Device operations that started inside the window."""
    lo, hi = trace.window
    return sum(1 for ev in trace.device if lo <= ev.start < hi)

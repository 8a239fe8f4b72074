"""The program's spans in a profiled window, and the card's time and idle
by span.

``nerf_tpu_torch.utils.profiling.annotate`` opens each span of the port as
a ``record_function`` range, which the Chrome trace holds as a
``user_annotation`` event on the host's clock that the device's events
share. Each device operation carries ``args.correlation``, the id of the
``cuda_runtime`` (or ``cuda_driver``) call that launched it on the host, so
an operation belongs to the span the host was in when it launched it,
whatever thread launched it (autograd's device thread launches the
backward while the step's thread waits inside ``train.backward``). An idle
gap belongs to the spans it overlaps.

A region is a set of stretches of the host's clock: the union of the spans
of some names, less the union of others'. ``split`` reads a partition of the
window into regions, and what falls in none of them.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, Iterable, List, NamedTuple, Optional, Sequence, Tuple

from . import trace as tr

LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
Intervals = List[Tuple[float, float]]


class Launched(NamedTuple):
    """A device operation (microseconds) and the host time of its launch
    (None where the trace holds no launch of its correlation)."""

    name: str
    start: float
    end: float
    launch: Optional[float]


class Phased(NamedTuple):
    trace: tr.Trace                   # the window as harness.trace reads it
    spans: Dict[str, Intervals]       # the program's spans by name, by start
    ops: List[Launched]               # the device operations, by start


def from_chrome(chrome: Dict) -> Phased:
    """The window, the program's spans and each device operation's launch
    time from a parsed Chrome trace holding one ``bench.window``."""
    spans: Dict[str, Intervals] = defaultdict(list)
    launch_at: Dict[int, float] = {}
    device = []
    for e in chrome.get("traceEvents", []):
        if e.get("ph") != "X" or "dur" not in e:
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        start = float(e["ts"])
        corr = (e.get("args") or {}).get("correlation")
        if cat in tr.DEVICE_CATS:
            device.append((name, start, start + float(e["dur"]), corr))
        elif cat in LAUNCH_CATS and corr is not None:
            launch_at[corr] = start
        elif cat == "user_annotation" and name != tr.WINDOW_SPAN:
            spans[name].append((start, start + float(e["dur"])))
    ops = sorted((Launched(n, s, e, launch_at.get(c)) for n, s, e, c in device),
                 key=lambda op: op.start)
    return Phased(tr.from_chrome(chrome), {k: sorted(v) for k, v in spans.items()}, ops)


# -- stretches of the host's clock ---------------------------------------
def union(ivs: Iterable[Tuple[float, float]]) -> Intervals:
    out: List[List[float]] = []
    for s, e in sorted(ivs):
        if e <= s:
            continue
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def intersect(a: Intervals, b: Intervals) -> Intervals:
    """Both merged and sorted."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if e > s:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def minus(a: Intervals, b: Intervals) -> Intervals:
    """``a`` less ``b``, both merged and sorted."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
            if s >= e:
                break
        if e > s:
            out.append((s, e))
    return out


def length(ivs: Intervals) -> float:
    return sum(e - s for s, e in ivs)


def region(ph: Phased, include: Sequence[str], exclude: Sequence[str] = ()) -> Intervals:
    """The window's stretches inside a span named in ``include`` and outside
    every span named in ``exclude``."""
    inside = union(iv for name in include for iv in ph.spans.get(name, ()))
    out = minus(inside, union(iv for name in exclude for iv in ph.spans.get(name, ())))
    return intersect(out, [ph.trace.window])


def outside(ph: Phased, regions: Iterable[Intervals]) -> Intervals:
    """The window less every stretch of ``regions``."""
    return minus([ph.trace.window], union(iv for r in regions for iv in r))


# -- what the card did in a region ----------------------------------------
def _contains(ivs: Intervals, t: Optional[float]) -> bool:
    if t is None:
        return False
    k = bisect.bisect_right(ivs, (t, float("inf"))) - 1
    return k >= 0 and ivs[k][0] <= t < ivs[k][1]


def launched_in(ph: Phased, ivs: Intervals) -> List[Launched]:
    """The device operations launched inside ``ivs``."""
    return [op for op in ph.ops if _contains(ivs, op.launch)]


def device_s(ph: Phased, ivs: Intervals) -> float:
    """The union of the intervals of the operations launched inside
    ``ivs``, clipped to the window, in seconds."""
    lo, hi = ph.trace.window
    return length(union((max(op.start, lo), min(op.end, hi))
                        for op in launched_in(ph, ivs))) / 1e6


def idle_s(ph: Phased, ivs: Intervals) -> float:
    """The card's idle time inside ``ivs``, in seconds."""
    return length(intersect(tr.idle_gaps(ph.trace), ivs)) / 1e6


def ops_by_name(ph: Phased, ivs: Intervals, units: int) -> List[List]:
    """The operations launched inside ``ivs`` by shortened name, most device
    time first: [name, ms a unit, launches a unit]."""
    lo, hi = ph.trace.window
    ms: Dict[str, float] = defaultdict(float)
    count: Dict[str, int] = defaultdict(int)
    for op in launched_in(ph, ivs):
        name = tr.short_name(op.name)
        ms[name] += max(0.0, min(op.end, hi) - max(op.start, lo)) / 1e3 / units
        count[name] += 1
    return [[k, v, count[k] / units] for k, v in sorted(ms.items(), key=lambda kv: -kv[1])]


def stats(ph: Phased, ivs: Intervals, units: int) -> Dict:
    """The card's time of the operations launched inside ``ivs`` and its idle
    time there, in ms a unit (a step or a frame), the launches a unit and
    those operations by name."""
    return {"device_ms": 1e3 * device_s(ph, ivs) / units,
            "idle_ms": 1e3 * idle_s(ph, ivs) / units,
            "launches": len(launched_in(ph, ivs)) / units,
            "ops": ops_by_name(ph, ivs, units)}


def split(ph: Phased, regions: Dict[str, Intervals], units: int) -> Dict[str, Dict]:
    """``stats`` of each region of a partition of the window and of what is
    ``outside`` them all; ``unmatched`` counts the operations whose launch the
    trace does not hold."""
    parts = list(regions.items()) + [("outside", outside(ph, regions.values()))]
    out = {name: stats(ph, ivs, units) for name, ivs in parts}
    out["unmatched"] = {"launches": sum(op.launch is None for op in ph.ops) / units}
    return out

"""What the per-layer readers share: the points a step or a frame evaluates,
a kernel's share of its roofline from the trace, and the whole step's or
frame's share of the card's peak.

``info`` is what ``run.run_cell`` hands a reader: ``window`` (the untraced
window: ``seconds`` and ``steps`` or ``frames``), ``traced`` (None, or the
profiled stretch: ``trace`` and its ``steps`` or ``frames``), ``config``
(the configuration's file), ``traffic`` and ``root`` (the checkout whose
model-type plug-ins count the fields; this one's where it is left out).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

from . import counts, spec
from . import trace as tr


def points(config: Dict, mode: str, rays: int) -> Tuple[int, int]:
    """Points the coarse and the fine field evaluate for ``rays`` rays in
    ``mode`` ("train" or "validation")."""
    p = config["nerf"][mode]
    nc, nf = int(p["num_coarse"]), int(p["num_fine"])
    return rays * nc, rays * (nc + nf)


def step_rays(config: Dict) -> int:
    return int(config["nerf"]["train"]["num_random_rays"])


def frame_rays(config: Dict) -> int:
    return int(config["dataset"]["height"]) * int(config["dataset"]["width"])


def _root(info: Dict):
    return info.get("root", spec.ROOT)


def _unit(info: Dict, key: str) -> Optional[int]:
    traced = info.get("traced")
    return None if traced is None else traced.get(key)


def idle_pct(info: Dict, key: str) -> Optional[float]:
    """100 - the device's busy share of the traced window, for traces of
    ``key`` ("steps" or "frames")."""
    if not _unit(info, key):
        return None
    t = info["traced"]["trace"]
    busy = tr.busy_s(t)
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / t.window_s)


def untraced_busy_pct(info: Dict, key: str) -> Optional[float]:
    """The device's busy time a traced step or frame (``key``), over the
    untraced window's time a step or frame, in %: the busy share of the
    work as timed, without the profiler's own host cost in the denominator."""
    units = _unit(info, key)
    window = info["window"]
    if not units or not window.get(key):
        return None
    busy = tr.busy_s(info["traced"]["trace"])
    if busy <= 0:
        return None
    return 100.0 * (busy / units) / (window["seconds"] / window[key])


def launches_per_unit(info: Dict, key: str) -> Optional[float]:
    """Device operations (kernels, copies, sets) that started in the traced
    window, a step or frame (``key``)."""
    units = _unit(info, key)
    if not units:
        return None
    launches = tr.device_launches(info["traced"]["trace"])
    return launches / units if launches else None


def device_ms_per_unit(info: Dict, key: str) -> Optional[float]:
    """The device's busy time (the union of its operations' intervals) a
    traced step or frame (``key``), in ms: what the work costs on the card,
    whatever the host's speed. None where no device operation ran."""
    units = _unit(info, key)
    if not units:
        return None
    busy = tr.busy_s(info["traced"]["trace"])
    return 1e3 * busy / units if busy > 0 else None


def roofline_pct(info: Dict, model_type: str, patterns: Sequence[str], training: bool
                 ) -> Optional[float]:
    """The least time of the field evaluations a traced step (``training``)
    or frame makes, over the device time of the kernels whose names match
    ``patterns``, in %. None where this cell's fields are of another type or
    no such kernel ran."""
    config = info["config"]
    model = config["models"]["coarse"]
    key = "steps" if training else "frames"
    units = _unit(info, key)
    if not units or model["type"] != model_type:
        return None
    mode = "train" if training else "validation"
    rays = step_rays(config) if training else frame_rays(config)
    dtype = str(config["nerf"][mode].get("compute_dtype", "float32"))
    root = _root(info)
    least = sum(counts.least_seconds(counts.field_flops(model, n, training, root),
                                     counts.field_bytes(model, rays, n, training, root), dtype)
                for n in points(config, mode, rays))
    seconds, launched = tr.matching_seconds(info["traced"]["trace"], patterns)
    if launched == 0 or seconds <= 0:
        return None
    return 100.0 * least * units / seconds


def _model_flops(info: Dict, training: bool) -> float:
    """The model's operations a training step (3 forwards of both fields,
    forward and backward by the usual rule) or a frame (1 forward)."""
    config = info["config"]
    model = config["models"]["coarse"]
    mode = "train" if training else "validation"
    rays = step_rays(config) if training else frame_rays(config)
    flops = sum(counts.field_flops(model, n, False, _root(info))
                for n in points(config, mode, rays))
    return (3 if training else 1) * flops


def _peak(config: Dict, training: bool) -> float:
    mode = "train" if training else "validation"
    return counts.PEAK_FLOPS[str(config["nerf"][mode].get("compute_dtype", "float32"))]


def mfu_pct(info: Dict, training: bool) -> Optional[float]:
    """The model's operations over the untraced window, over the card's peak
    at the compute precision, in %."""
    config = info["config"]
    window = info["window"]
    key = "steps" if training else "frames"
    if key not in window:
        return None
    flops = _model_flops(info, training) * window[key]
    return 100.0 * flops / window["seconds"] / _peak(config, training)


def device_mfu_pct(info: Dict, training: bool) -> Optional[float]:
    """The model's operations a traced step or frame, over the device's busy
    time a step or frame (``device_ms_per_unit``), over the card's peak at
    the compute precision, in %: the whole step's share of the peak on the
    card's own time."""
    ms = device_ms_per_unit(info, "steps" if training else "frames")
    if ms is None:
        return None
    config = info["config"]
    return 100.0 * _model_flops(info, training) / (1e-3 * ms) / _peak(config, training)

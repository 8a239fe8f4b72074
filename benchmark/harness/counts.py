"""Published peaks of the card and the operations and bytes of a radiance
field, counted from a configuration's widths.

Each model type's plug-in (``models/<type>.py``) counts its own field:
``flops(model, points, backward)`` and ``nbytes(model, rays, points,
backward)``, each standing alone, so that a field bound by its bytes is
counted as such. The arithmetic of a stack of dense layers is here, for the
plug-ins of the MLPs: they follow the published equations one point at a
time, the direction branch counted per point as the equations write it, even
where a kernel evaluates its direction columns once a ray. Nothing here
reads what a kernel does.
"""

from __future__ import annotations

from pathlib import Path
from typing import Dict, NamedTuple, Sequence

from . import spec

# NVIDIA H100 SXM data sheet, dense rates without sparsity, at 700 W.
PEAK_FLOPS = {"bfloat16": 989e12, "float16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


class Dense(NamedTuple):
    """One linear layer: ``fan_in`` inputs, ``fan_out`` outputs, and how many
    of its inputs need a gradient in training (the encoded points and view
    directions get none)."""

    name: str
    fan_in: int
    fan_out: int
    grad_in: int


def encoding_width(num_fn: int, include_input: bool = True) -> int:
    """Width of the sinusoidal encoding of a 3-vector."""
    return (3 if include_input else 0) + 6 * num_fn


Layers = Sequence[Dense]


def forward_macs(layers: Layers) -> int:
    """Multiply-adds of one point's forward."""
    return sum(d.fan_in * d.fan_out for d in layers)


def input_grad_macs(layers: Layers) -> int:
    """Multiply-adds of one point's layer gradients (to each layer's inputs
    that need one)."""
    return sum(d.grad_in * d.fan_out for d in layers)


def weight_grad_macs(layers: Layers) -> int:
    """Multiply-adds of one point's weight gradients: one a weight."""
    return forward_macs(layers)


def num_params(layers: Layers) -> int:
    """Weights and biases of the layers the forward runs."""
    return sum(d.fan_in * d.fan_out + d.fan_out for d in layers)


def dense_flops(layers: Layers, points: int, backward: bool) -> float:
    """Operations (2 a multiply-add) of a forward over ``points`` points, and
    with ``backward`` of its backward too (layer and weight gradients)."""
    macs = forward_macs(layers)
    if backward:
        macs += input_grad_macs(layers) + weight_grad_macs(layers)
    return 2.0 * macs * points


def dense_bytes(layers: Layers, rays: int, points: int, backward: bool) -> float:
    """Bytes a field evaluation must move at least, each input read once and
    each output written once, in f32: points (3) and view directions (3 a
    ray) and the weights in, raw rgb + sigma (4) out; with ``backward``, the
    cotangent (4 a point) in and the weight gradients out as well."""
    nbytes = 4.0 * (3 * points + 3 * rays + num_params(layers) + 4 * points)
    if backward:
        nbytes += 4.0 * (4 * points + 3 * points + 3 * rays + 2 * num_params(layers))
    return nbytes


def field_flops(model: Dict, points: int, backward: bool, root: Path = spec.ROOT) -> float:
    """Operations of a field evaluation of ``model`` (a configuration's
    ``models.coarse`` entry) over ``points`` points, with ``backward`` its
    backward's too, as its type's plug-in counts them."""
    return spec.model_type(model["type"], root).plugin.flops(model, points, backward)


def field_bytes(model: Dict, rays: int, points: int, backward: bool,
                root: Path = spec.ROOT) -> float:
    """Bytes a field evaluation of ``model`` over ``points`` points of
    ``rays`` rays must move at least, as its type's plug-in counts them."""
    return spec.model_type(model["type"], root).plugin.nbytes(model, rays, points, backward)


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of the operations over the peak of ``dtype`` and the bytes
    over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)

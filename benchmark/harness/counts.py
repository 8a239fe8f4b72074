"""Published peaks of the card and the operations and bytes of a radiance
field, counted from a configuration's widths.

The counts follow the published equations of each MLP, one point at a time:
the direction branch is counted per point, as the equations write it, even
where a kernel evaluates its direction columns once a ray. Nothing here
reads what a kernel does.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple

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


def dense_layers(model: Dict) -> List[Dense]:
    """The layers of ``model`` (a configuration's ``models.coarse`` entry)
    in the order the forward runs them."""
    xyz = encoding_width(int(model["num_encoding_fn_xyz"]), model.get("include_input_xyz", True))
    dirs = encoding_width(int(model["num_encoding_fn_dir"]), model.get("include_input_dir", True))
    kind = model["type"]
    if kind == "FlexibleNeRFModel":
        h = int(model["hidden_size"])
        n = int(model["num_layers"])
        every = int(model.get("skip_connect_every", 4))
        layers = [Dense("layer1", xyz, h, 0)]
        for i in range(n - 1):
            skip = i % every == 0 and i > 0 and i != n - 1
            layers.append(Dense(f"layers_xyz.{i}", h + (xyz if skip else 0), h, h))
        if not model.get("use_viewdirs", True):
            return layers + [Dense("fc_out", h, 4, h)]
        return layers + [
            Dense("fc_feat", h, h, h),
            Dense("fc_alpha", h, 1, h),
            Dense("layers_dir.0", h + dirs, h // 2, h),
            Dense("fc_rgb", h // 2, 3, h // 2),
        ]
    if kind == "PaperNeRFModel":
        # Fig. 7 of arXiv:2003.08934 as the reference code builds it: the
        # encoding re-enters before the fifth layer, alpha is read from
        # fc_feat, and two further 128-wide direction layers run (a third is
        # built and never run).
        layers = [Dense("layers_xyz.0", xyz, 256, 0)]
        for i in range(1, 8):
            layers.append(Dense(f"layers_xyz.{i}", 256 + (xyz if i == 4 else 0), 256, 256))
        return layers + [
            Dense("fc_feat", 256, 256, 256),
            Dense("fc_alpha", 256, 1, 256),
            Dense("layers_dir.0", 256 + dirs, 128, 256),
            Dense("layers_dir.1", 128, 128, 128),
            Dense("layers_dir.2", 128, 128, 128),
            Dense("fc_rgb", 128, 3, 128),
        ]
    raise ValueError(f"no operation count for model type {kind!r}")


def forward_macs(model: Dict) -> int:
    """Multiply-adds of one point's forward."""
    return sum(d.fan_in * d.fan_out for d in dense_layers(model))


def input_grad_macs(model: Dict) -> int:
    """Multiply-adds of one point's layer gradients (to each layer's inputs
    that need one)."""
    return sum(d.grad_in * d.fan_out for d in dense_layers(model))


def weight_grad_macs(model: Dict) -> int:
    """Multiply-adds of one point's weight gradients: one a weight."""
    return forward_macs(model)


def num_params(model: Dict) -> int:
    """Weights and biases of the layers the forward runs."""
    return sum(d.fan_in * d.fan_out + d.fan_out for d in dense_layers(model))


def field_flops(model: Dict, points: int, backward: bool) -> float:
    """Operations (2 a multiply-add) of a forward over ``points`` points, and
    with ``backward`` of its backward too (layer and weight gradients)."""
    macs = forward_macs(model)
    if backward:
        macs += input_grad_macs(model) + weight_grad_macs(model)
    return 2.0 * macs * points


def field_bytes(model: Dict, rays: int, points: int, backward: bool) -> float:
    """Bytes a field evaluation must move at least, each input read once and
    each output written once, in f32: points (3) and view directions (3 a
    ray) and the weights in, raw rgb + sigma (4) out; with ``backward``, the
    cotangent (4 a point) in and the weight gradients out as well."""
    nbytes = 4.0 * (3 * points + 3 * rays + num_params(model) + 4 * points)
    if backward:
        nbytes += 4.0 * (4 * points + 3 * points + 3 * rays + 2 * num_params(model))
    return nbytes


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    """The larger of the operations over the peak of ``dtype`` and the bytes
    over the memory rate."""
    return max(flops / PEAK_FLOPS[dtype], nbytes / HBM_BYTES_PER_S)

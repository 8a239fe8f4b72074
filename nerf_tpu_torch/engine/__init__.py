"""Rendering engine and checkpoint I/O."""

from .checkpoint import (
    convert_torch_state_dict,
    load_jax_params,
    load_models_and_params,
    load_reference_checkpoint,
    to_torch_state_dict,
)
from .renderer import (
    RayRenderResult,
    RenderSettings,
    encode_points,
    make_image_render_fn,
    make_pose_render_fn,
    make_render_fn,
    render_maps_dict,
    render_rays,
)

__all__ = [
    "convert_torch_state_dict",
    "load_jax_params",
    "load_models_and_params",
    "load_reference_checkpoint",
    "to_torch_state_dict",
    "RayRenderResult",
    "RenderSettings",
    "encode_points",
    "make_image_render_fn",
    "make_pose_render_fn",
    "make_render_fn",
    "render_maps_dict",
    "render_rays",
]

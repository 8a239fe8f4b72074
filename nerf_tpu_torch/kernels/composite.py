"""One-pass volume compositing of a sampled radiance field (deterministic).

Replaces ``nerf_tpu/ops/pallas/composite.py:fused_volume_render`` with a
hand-written CUDA kernel for Hopper (``csrc/composite.cu``): raw (N, S, 4)
[r, g, b, sigma] f32 at depths (N, S) along (N, 3) un-normalized directions
-> the five maps ``rgb`` (N, 3), ``disp``, ``acc``, ``depth`` (N,) and
``weights`` (N, S), f32, with no sigma noise and an optional white
background.

What bounds it on the card is memory traffic: ~24 B a sample against ~25
operations. The kernel reads the field, the depths and the directions once
and writes the maps once, one warp a ray, the transmittance a product scan
across the warp (``csrc/composite.cuh``, which the whole-stage kernel
shares).

The plain version ``volume_render_plain`` is the deterministic branch of
``ops/volume.volume_render_radiance_field``.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from ..ops.volume import volume_render_radiance_field

MAP_NAMES = ("rgb", "disp", "acc", "depth", "weights")


def volume_render_plain(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    ray_directions: torch.Tensor,
    white_background: bool = False,
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel, same semantics: the five maps."""
    out = volume_render_radiance_field(radiance_field, depth_values, ray_directions,
                                       white_background=white_background)
    return {name: getattr(out, name) for name in MAP_NAMES}


def empty_maps(n: int, s: int, device) -> Dict[str, torch.Tensor]:
    """Uninitialised f32 output maps of ``n`` rays of ``s`` samples."""
    shapes = {"rgb": (n, 3), "disp": (n,), "acc": (n,), "depth": (n,), "weights": (n, s)}
    return {name: torch.empty(shape, dtype=torch.float32, device=device)
            for name, shape in shapes.items()}


def check_ray_inputs(name: str, z_vals: torch.Tensor, ray_directions: torch.Tensor,
                     n: int, s: int, device) -> None:
    """Raise unless depths are (n, s) and directions (n, 3), f32, on ``device``."""
    if tuple(z_vals.shape) != (n, s) or tuple(ray_directions.shape) != (n, 3):
        raise ValueError(
            f"{name}: want depths ({n}, {s}) and directions ({n}, 3), got "
            f"{tuple(z_vals.shape)} and {tuple(ray_directions.shape)}"
        )
    if z_vals.dtype != torch.float32 or ray_directions.dtype != torch.float32:
        raise ValueError(f"{name}: depths and directions must be float32")
    if z_vals.device != device or ray_directions.device != device:
        raise ValueError(f"{name}: every input must be on {device}")


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    fn = load_library().nerf_composite_forward
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_volume_render(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    ray_directions: torch.Tensor,
    white_background: bool = False,
) -> Dict[str, torch.Tensor]:
    """Composite ``radiance_field`` (N, S, 4) at ``depth_values`` (N, S)
    along ``ray_directions`` (N, 3): {"rgb", "disp", "acc", "depth",
    "weights"}.

    CPU tensors go through ``volume_render_plain``. CUDA tensors go through
    the kernel; anything it does not take raises.
    ``fused_volume_render.launches`` counts the kernel's launches.
    """
    rf = radiance_field
    if rf.device.type == "cpu":
        return volume_render_plain(rf, depth_values, ray_directions, white_background)
    if rf.device.type != "cuda":
        raise ValueError(f"fused_volume_render: no kernel for device {rf.device}")
    if rf.ndim != 3 or rf.shape[-1] != 4 or rf.shape[1] == 0:
        raise ValueError(f"fused_volume_render: want a (N, S > 0, 4) field, got "
                         f"{tuple(rf.shape)}")
    if rf.dtype != torch.float32:
        raise ValueError("fused_volume_render: the field must be float32")
    n, s = rf.shape[0], rf.shape[1]
    check_ray_inputs("fused_volume_render", depth_values, ray_directions, n, s, rf.device)

    out = empty_maps(n, s, rf.device)
    if n == 0:
        return out
    with torch.cuda.device(rf.device):
        rf_c, z_c, rd_c = (t.contiguous() for t in (rf, depth_values, ray_directions))
        stream = torch.cuda.current_stream(rf.device).cuda_stream
        rc = _kernel()(
            rf_c.data_ptr(), z_c.data_ptr(), rd_c.data_ptr(),
            *(out[name].data_ptr() for name in MAP_NAMES),
            n, s, int(white_background), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_volume_render: kernel launch failed with CUDA error {rc}")
    fused_volume_render.launches += 1
    return out


fused_volume_render.launches = 0

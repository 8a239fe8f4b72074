"""A whole render stage of the 4x128 FlexibleNeRF: encode + MLP + compositing.

Replaces ``nerf_tpu/ops/pallas/stage.py:fused_render_stage`` with a
hand-written CUDA kernel for Hopper (``csrc/stage.cu``): sample points
(N, S, 3) seen along ``viewdirs`` (N, 3) at depths (N, S) on rays of
directions (N, 3) -> the five maps of ``kernels/composite.py`` (``rgb``,
``disp``, ``acc``, ``depth``, ``weights``), f32, deterministic, optional
white background. The (N, S, 4) radiance field never reaches device memory.

What bounds it on the card is the MLP's arithmetic (that of
``kernels/mlp_t.py``); the kernel runs the forward of ``fused_mlp_t`` over
the tiles of a block's rays into shared memory (f32: ``csrc/flex_mlp.cuh``'s
FMA tile; bf16: ``csrc/flex_tc.cuh``'s tensor-core tile on the weights
``mlp.IMAGES.tc_forward``), then ``csrc/composite.cuh``'s scan over
them. The per-ray direction contribution and the packed parameters are
``mlp.dir_contribution`` and ``mlp.pack_params``, and the shape gate is
``mlp.supports_fused``, 10 encoding frequencies included. The bf16 maps are
bitwise those of ``fused_volume_render`` on ``fused_mlp_t``'s bf16 field.

The plain version ``render_stage_plain`` is ``mlp_t_plain`` (that is,
``mlp.flexible_mlp_rays_plain``) followed by ``volume_render_plain``;
``compute_dtype="bfloat16"`` rounds the MLP's operands as ``mlp_t_plain``
emulates it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from .common import check_forward, check_rc, cuda_stream
from .composite import MAP_NAMES, check_ray_inputs, empty_maps, volume_render_plain
from .mlp import IMAGES, dir_contribution, flexible_mlp_rays_plain, pack_params, supports_fused


def render_stage_plain(
    model,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    ray_directions: torch.Tensor,
    white_background: bool = False,
    compute_dtype: str = "float32",
) -> Dict[str, torch.Tensor]:
    """Plain PyTorch version of the kernel, same semantics: the five maps."""
    rf = flexible_mlp_rays_plain(model, pts, viewdirs, compute_dtype)
    return volume_render_plain(rf, z_vals, ray_directions, white_background)


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    lib = load_library()
    fn = lib.nerf_stage_forward
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr] * 5 + [i64, ptr, i64] + [ptr] * 5 + [i64, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    return fn, lib.nerf_stage_max_samples()


def fused_render_stage(
    model,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    z_vals: torch.Tensor,
    ray_directions: torch.Tensor,
    white_background: bool = False,
    compute_dtype: str = "float32",
) -> Dict[str, torch.Tensor]:
    """Render stage of ``model`` at ``pts`` (N, S, 3): {"rgb", "disp",
    "acc", "depth", "weights"}.

    CPU tensors go through ``render_stage_plain``. CUDA tensors go through
    the kernel; anything it does not take raises.
    ``fused_render_stage.launches`` counts the kernel's launches.
    """
    what = "fused_render_stage"
    if check_forward(what, supports_fused(model), "the 4x128 10/4 FlexibleNeRF shape",
                     compute_dtype, model, pts, viewdirs):
        return render_stage_plain(model, pts, viewdirs, z_vals, ray_directions,
                                  white_background, compute_dtype)
    n, s = pts.shape[0], pts.shape[1]
    if s == 0:
        raise ValueError(f"{what}: want pts (N, S > 0, 3), got {tuple(pts.shape)}")
    check_ray_inputs(what, z_vals, ray_directions, n, s, pts.device)
    out = empty_maps(n, s, pts.device)
    if n == 0:
        return out
    # dc, params and wbf are freed when this returns, before the kernel may
    # have run: the caching allocator hands their blocks out again only in
    # this stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        fn, max_samples = _kernel()
        if s > max_samples:
            raise ValueError(f"{what}: the kernel takes at most {max_samples} samples a ray, "
                             f"got {s}")
        pts_c, z_c, rd_c = (t.contiguous() for t in (pts, z_vals, ray_directions))
        dc = dir_contribution(model, viewdirs).contiguous()
        params = pack_params(model).contiguous()
        wbf = IMAGES.tc_forward.pack(params) if compute_dtype == "bfloat16" else None
        check_rc(what, fn(
            pts_c.data_ptr(), z_c.data_ptr(), rd_c.data_ptr(), dc.data_ptr(), params.data_ptr(),
            params.numel(), None if wbf is None else wbf.data_ptr(),
            0 if wbf is None else wbf.numel(), *(out[name].data_ptr() for name in MAP_NAMES),
            n, s, int(white_background), int(wbf is not None), cuda_stream(pts.device),
        ))
    fused_render_stage.launches += 1
    return out


fused_render_stage.launches = 0

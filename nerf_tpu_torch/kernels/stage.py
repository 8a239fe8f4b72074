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
``mlp.pack_tc_forward`` builds), then ``csrc/composite.cuh``'s scan over
them. The per-ray direction contribution and the packed parameters are
``mlp.dir_contribution`` and ``mlp.pack_params``, and the shape gate is
``mlp.supports_fused``, 10 encoding frequencies included. The bf16 maps are
bitwise those of ``fused_volume_render`` on ``fused_mlp_t``'s bf16 field.

The plain version ``render_stage_plain`` is ``mlp_t_plain`` followed by
``volume_render_plain``; ``compute_dtype="bfloat16"`` rounds the MLP's
operands as ``mlp_t_plain`` emulates it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import torch

from .composite import MAP_NAMES, check_ray_inputs, empty_maps, volume_render_plain
from .mlp import _COMPUTE_DTYPES, dir_contribution, pack_params, pack_tc_forward, supports_fused
from .mlp_t import mlp_t_plain


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
    rf = mlp_t_plain(model, pts, viewdirs, compute_dtype)
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
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    if not supports_fused(model):
        raise ValueError("fused_render_stage: model is not the 4x128 10/4 FlexibleNeRF shape")
    if pts.device.type == "cpu":
        return render_stage_plain(model, pts, viewdirs, z_vals, ray_directions,
                                  white_background, compute_dtype)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_render_stage: no kernel for device {pts.device}")
    if (pts.ndim != 3 or pts.shape[-1] != 3 or pts.shape[1] == 0
            or tuple(viewdirs.shape) != (pts.shape[0], 3)):
        raise ValueError(
            f"fused_render_stage: want pts (N, S > 0, 3) and viewdirs (N, 3), got "
            f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}"
        )
    if pts.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise ValueError("fused_render_stage: pts and viewdirs must be float32")
    n, s = pts.shape[0], pts.shape[1]
    check_ray_inputs("fused_render_stage", z_vals, ray_directions, n, s, pts.device)
    if viewdirs.device != pts.device or model.layer1.weight.device != pts.device:
        raise ValueError("fused_render_stage: the inputs and the model must share a device")

    out = empty_maps(n, s, pts.device)
    if n == 0:
        return out
    # dc, params and wbf are freed when this returns, before the kernel may
    # have run: the caching allocator hands their blocks out again only in
    # this stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        fn, max_samples = _kernel()
        if s > max_samples:
            raise ValueError(f"fused_render_stage: the kernel takes at most {max_samples} "
                             f"samples a ray, got {s}")
        pts_c, z_c, rd_c = (t.contiguous() for t in (pts, z_vals, ray_directions))
        dc = dir_contribution(model, viewdirs).contiguous()
        params = pack_params(model).contiguous()
        wbf = pack_tc_forward(params) if compute_dtype == "bfloat16" else None
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = fn(
            pts_c.data_ptr(), z_c.data_ptr(), rd_c.data_ptr(), dc.data_ptr(), params.data_ptr(),
            params.numel(), None if wbf is None else wbf.data_ptr(),
            0 if wbf is None else wbf.numel(), *(out[name].data_ptr() for name in MAP_NAMES),
            n, s, int(white_background), int(wbf is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_render_stage: kernel launch failed with CUDA error {rc}")
    fused_render_stage.launches += 1
    return out


fused_render_stage.launches = 0

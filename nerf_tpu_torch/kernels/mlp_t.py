"""Fused encode + MLP radiance-field evaluation of the 4x128 FlexibleNeRF.

Replaces ``nerf_tpu/ops/pallas/mlp_t.py:fused_mlp_t`` with a hand-written
CUDA kernel for Hopper (``csrc/mlp_t.cu``): (N, S, 3) points + (N, 3)
viewdirs -> (N, S, 4) raw [r, g, b, sigma] f32, with the positional
encoding, the trunk, fc_feat/fc_alpha, the direction layer and fc_rgb in one
launch whose activations stay in shared memory and registers.

What bounds it on the card is arithmetic: ~82k multiply-adds per point
against 28 B of point traffic. Both instances keep every activation of a
64-point tile on chip (the source note in ``csrc/mlp_t.cu`` has the
details). ``compute_dtype="float32"`` runs f32 FMAs from registers (~24
TFLOP/s on an H100 SXM at 700 W, about 35% of the f32 FMA peak);
``"bfloat16"`` runs every wide product on the tensor cores by ``wgmma``
(bf16 operands, f32 sums; ``csrc/flex_wg.cuh``: one persistent,
warp-specialised block an SM whose producer warpgroup encodes the next
tiles while its consumers multiply), its weights handed over as the bf16
shared-memory image the kernel keeps resident (``kernels/mlp.IMAGES``'
``wg_forward``), built once per call. Its outputs are bitwise those of the ``mma.sync`` tile
(``csrc/flex_tc.cuh``) that the other bf16 4x128 kernels run.

Like the TPU version, the per-ray direction contribution
``enc(viewdirs) @ W_dir[128:]`` (N, 64) is computed outside the kernel with
one matmul and added to each sample's direction-layer pre-activation inside.

``compute_dtype="bfloat16"`` rounds both operands of every matmul to bf16 and
keeps f32 sums, as the TPU kernel does (``preferred_element_type=f32``). The
plain version ``mlp_t_plain`` (``kernels/mlp.flexible_mlp_rays_plain``)
emulates exactly that with ``.bfloat16().float()`` and f32 matmuls; a bf16
``torch.matmul`` would round its output too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.mlp import FlexibleNeRFModel
from .common import check_forward, check_rc, cuda_stream
from .mlp import (
    _NUM_PARAMS,
    IMAGES,
    dir_contribution,
    flexible_mlp_rays_plain,
    pack_params,
    supports_fused,
)

# #1 computes the ray-major kernel's function: one plain version serves both.
mlp_t_plain = flexible_mlp_rays_plain


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    lib = load_library()
    fn = lib.nerf_mlp_t_forward
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr, i64, i32, i32, ptr]
    fn.restype = ctypes.c_int
    got = (lib.nerf_mlp_t_num_params(), lib.nerf_mlp_t_wg_weights())
    want = (_NUM_PARAMS, IMAGES.wg_forward.size)
    if got != want:
        raise RuntimeError(f"csrc/flex_mlp.cuh / flex_wg.cuh layouts {got} != wrapper's {want}")
    return fn


def fused_mlp_t(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Radiance field of ``model`` at ``pts`` (N, S, 3) seen along ``viewdirs``
    (N, 3): (N, S, 4) raw [r, g, b, sigma] f32.

    CPU tensors go through ``mlp_t_plain``. CUDA tensors go through the
    kernel; anything it does not take raises. ``fused_mlp_t.launches``
    counts the kernel's launches, ``fused_mlp_t.wgmma_launches`` those of
    its bf16 instance (``csrc/flex_wg.cuh``).
    """
    if check_forward("fused_mlp_t", supports_fused(model), "the 4x128 10/4 FlexibleNeRF shape",
                     compute_dtype, model, pts, viewdirs):
        return mlp_t_plain(model, pts, viewdirs, compute_dtype)
    n, s = pts.shape[0], pts.shape[1]
    out = torch.empty((n, s, 4), dtype=torch.float32, device=pts.device)
    if n * s == 0:
        return out
    # dc, params and wbf are freed when this returns, before the kernel may
    # have run: the caching allocator hands their blocks out again only in
    # this stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        pts_c = pts.contiguous()
        dc = dir_contribution(model, viewdirs).contiguous()
        params = pack_params(model).contiguous()
        wbf = IMAGES.wg_forward.pack(params) if compute_dtype == "bfloat16" else None
        check_rc("fused_mlp_t", _kernel()(
            pts_c.data_ptr(), dc.data_ptr(), params.data_ptr(), params.numel(),
            None if wbf is None else wbf.data_ptr(), 0 if wbf is None else wbf.numel(),
            out.data_ptr(), n * s, s, int(wbf is not None), cuda_stream(pts.device),
        ))
    fused_mlp_t.launches += 1
    fused_mlp_t.wgmma_launches += wbf is not None
    return out


fused_mlp_t.launches = 0
fused_mlp_t.wgmma_launches = 0

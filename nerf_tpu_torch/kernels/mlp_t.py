"""Fused encode + MLP radiance-field evaluation of the 4x128 FlexibleNeRF.

Replaces ``nerf_tpu/ops/pallas/mlp_t.py:fused_mlp_t`` with a hand-written
CUDA kernel for Hopper (``csrc/mlp_t.cu``): (N, S, 3) points + (N, 3)
viewdirs -> (N, S, 4) raw [r, g, b, sigma] f32, with the positional
encoding, the trunk, fc_feat/fc_alpha, the direction layer and fc_rgb in one
launch whose activations stay in shared memory and registers.

What bounds it on the card is arithmetic: ~82k multiply-adds per point
against 28 B of point traffic. The first design keeps every activation of a
64-point tile on chip and runs f32 FMAs from registers (the source note in
``csrc/mlp_t.cu`` has the details): ~24 TFLOP/s on an H100 SXM at 700 W,
about 35% of the f32 FMA peak. Tensor cores are later work.

Like the TPU version, the per-ray direction contribution
``enc(viewdirs) @ W_dir[128:]`` (N, 64) is computed outside the kernel with
one matmul and added to each sample's direction-layer pre-activation inside.

``compute_dtype="bfloat16"`` rounds both operands of every matmul to bf16 and
keeps f32 sums, as the TPU kernel does (``preferred_element_type=f32``). The
plain version ``mlp_t_plain`` emulates exactly that with ``.bfloat16().float()``
and f32 matmuls; a bf16 ``torch.matmul`` would round its output too.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models.mlp import FlexibleNeRFModel
from ..ops.encoding import positional_encoding

_NUM_FREQ_XYZ = 10
_NUM_FREQ_DIR = 4
_DIM_XYZ = 3 + 6 * _NUM_FREQ_XYZ   # 63
_HIDDEN = 128
_COMPUTE_DTYPES = ("float32", "bfloat16")


def supports_fused(model) -> bool:
    """True when ``model`` is the default FlexibleNeRF shape the kernel fuses
    (the gate of ``nerf_tpu/ops/pallas/mlp.py:supports_fused``)."""
    return (
        isinstance(model, FlexibleNeRFModel)
        and model.num_layers == 4
        and model.hidden_size == _HIDDEN
        and model.use_viewdirs
        and model.num_encoding_fn_xyz == _NUM_FREQ_XYZ
        and model.num_encoding_fn_dir == _NUM_FREQ_DIR
        and model.include_input_xyz
        and model.include_input_dir
        and len(model.layers_xyz) == 3
        and tuple(model.layer1.weight.shape) == (_HIDDEN, _DIM_XYZ)
    )


def dir_contribution(model: FlexibleNeRFModel, viewdirs: torch.Tensor) -> torch.Tensor:
    """Per-ray ``enc(viewdirs) @ W_dir[128:]``: (N, 3) -> (N, 64) f32.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's own
    default): f32 here means full f32 on the card, not TF32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    direnc = positional_encoding(viewdirs.float(), _NUM_FREQ_DIR)      # (N, 27)
    w_dir = model.layers_dir[0].weight[:, _HIDDEN:].float()           # (64, 27)
    return direnc @ w_dir.t()


def mlp_t_plain(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Plain PyTorch version of the kernel, same semantics: (N, S, 4) f32."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    bf16 = compute_dtype == "bfloat16"

    def r(x):
        return x.bfloat16().float() if bf16 else x

    def dense(layer, x, cols=None):
        w = layer.weight if cols is None else layer.weight[:, cols]
        return r(x) @ r(w.float()).t() + layer.bias.float()

    dc = dir_contribution(model, viewdirs)                          # (N, 64)
    enc = positional_encoding(pts.float(), _NUM_FREQ_XYZ)           # (N, S, 63)
    h = dense(model.layer1, enc)
    for layer in model.layers_xyz:
        h = torch.relu(dense(layer, h))
    feat = torch.relu(dense(model.fc_feat, h))
    sigma = dense(model.fc_alpha, h)
    hd = torch.relu(
        dense(model.layers_dir[0], feat, cols=slice(0, _HIDDEN)) + dc[:, None, :]
    )
    rgb = dense(model.fc_rgb, hd)
    return torch.cat([rgb, sigma], dim=-1)


def pack_params(model: FlexibleNeRFModel) -> torch.Tensor:
    """The kernel's parameter buffer: each layer's (in, out) weight, then its
    bias, in the order of the offsets in ``csrc/mlp_t.cu``."""
    parts = [model.layer1.weight.t(), model.layer1.bias]
    for layer in model.layers_xyz:
        parts += [layer.weight.t(), layer.bias]
    parts += [
        model.fc_feat.weight.t(), model.fc_feat.bias,
        model.fc_alpha.weight.t(), model.fc_alpha.bias,
        model.layers_dir[0].weight[:, :_HIDDEN].t(), model.layers_dir[0].bias,
        model.fc_rgb.weight.t(), model.fc_rgb.bias,
    ]
    return torch.cat([p.float().reshape(-1) for p in parts])


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    lib = load_library()
    fn = lib.nerf_mlp_t_forward
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
        ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
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
    counts the kernel's launches.
    """
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    if not supports_fused(model):
        raise ValueError("fused_mlp_t: model is not the 4x128 10/4 FlexibleNeRF shape")
    if pts.device.type == "cpu":
        return mlp_t_plain(model, pts, viewdirs, compute_dtype)
    if pts.device.type != "cuda":
        raise ValueError(f"fused_mlp_t: no kernel for device {pts.device}")
    if pts.ndim != 3 or pts.shape[-1] != 3 or tuple(viewdirs.shape) != (pts.shape[0], 3):
        raise ValueError(
            f"fused_mlp_t: want pts (N, S, 3) and viewdirs (N, 3), got "
            f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}"
        )
    if pts.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise ValueError("fused_mlp_t: pts and viewdirs must be float32")
    if viewdirs.device != pts.device or model.layer1.weight.device != pts.device:
        raise ValueError("fused_mlp_t: pts, viewdirs and the model must share a device")

    n, s = pts.shape[0], pts.shape[1]
    out = torch.empty((n, s, 4), dtype=torch.float32, device=pts.device)
    if n * s == 0:
        return out
    # dc and params are freed when this returns, before the kernel may have
    # run: the caching allocator hands their blocks out again only in this
    # stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        pts_c = pts.contiguous()
        dc = dir_contribution(model, viewdirs).contiguous()
        params = pack_params(model).contiguous()
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = _kernel()(
            pts_c.data_ptr(), dc.data_ptr(), params.data_ptr(), params.numel(),
            out.data_ptr(), n * s, s, int(compute_dtype == "bfloat16"), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_mlp_t: kernel launch failed with CUDA error {rc}")
    fused_mlp_t.launches += 1
    return out


fused_mlp_t.launches = 0

"""Fused encode + MLP radiance-field evaluation of the 8x256 PaperNeRF.

Replaces ``nerf_tpu/ops/pallas/paper_t.py:fused_paper_mlp_t`` with a
hand-written CUDA kernel for Hopper (``csrc/paper_t.cu``, device code in
``csrc/paper_mlp.cuh``): (N, S, 3) points + (N, 3) viewdirs -> (N, S, 4) raw
[r, g, b, sigma] f32, with the positional encoding, the 8-layer trunk and its
skip at layer 4, fc_feat, sigma (read from feat), the three live direction
layers and fc_rgb in one launch whose activations stay in shared memory and
registers. The encoding depth is the model's ``num_encoding_fn_xyz``, a
runtime argument of the kernel (0 to 16).

What bounds it on the card is arithmetic: 622,720 multiply-adds a point at
10 frequencies against 28 B of point traffic. The first design runs f32 FMAs
from registers (the source note in ``csrc/paper_t.cu`` has the details);
tensor cores are later work.

Like the TPU version, the per-ray direction contribution
``enc(viewdirs) @ W_dir[:, 256:].T`` (N, 128) is computed outside the kernel
with one matmul and added to each sample's layers_dir.0 pre-activation inside.

``compute_dtype="bfloat16"`` rounds both operands of every matmul to bf16 and
keeps f32 sums, as the TPU kernel does (``preferred_element_type=f32``). The
plain version emulates exactly that with ``.bfloat16().float()`` and f32
matmuls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Tuple

import torch

from ..models.mlp import PaperNeRFModel
from ..ops.encoding import positional_encoding
from .flex_train import _aligned, _rounder
from .mlp_t import _COMPUTE_DTYPES

_WIDTH = 256
_DIR_WIDTH = 128
_MAX_FREQ = 16             # encoding depths the kernels take (csrc/paper_mlp.cuh kMaxFreq)


def supports_fused_paper(model) -> bool:
    """True when ``model`` is a PaperNeRF shape the kernels fuse (the gate of
    ``nerf_tpu/ops/pallas/paper_t.py:supports_fused_paper``: the encoding
    depth is free, within the kernels' 0..16)."""
    return (
        isinstance(model, PaperNeRFModel)
        and model.use_viewdirs
        and model.include_input_xyz
        and model.include_input_dir
        and len(model.layers_xyz) == 8
        and len(model.layers_dir) == 4
        and tuple(model.layers_xyz[1].weight.shape) == (_WIDTH, _WIDTH)
        and 0 <= model.num_encoding_fn_xyz <= _MAX_FREQ
    )


def dir_contribution(model: PaperNeRFModel, viewdirs: torch.Tensor) -> torch.Tensor:
    """Per-ray ``enc(viewdirs) @ W_dir[:, 256:].T``: (N, 3) -> (N, 128) f32.

    Sets ``torch.backends.cuda.matmul.allow_tf32 = False`` (PyTorch's own
    default): f32 here means full f32 on the card, not TF32.
    """
    torch.backends.cuda.matmul.allow_tf32 = False
    direnc = positional_encoding(viewdirs.float(), model.num_encoding_fn_dir)
    return direnc @ model.layers_dir[0].weight[:, _WIDTH:].float().t()


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def layout(num_freq: int) -> List[Tuple[str, int, int]]:
    """The packed parameter buffer's layers, in order: (name, in, out); each
    (in, out) weight and its (out,) bias are padded to a multiple of 4 floats
    (``csrc/paper_mlp.cuh`` ``make_layout``)."""
    dim = 3 + 6 * num_freq
    out = [(f"layers_xyz.{i}", dim if i == 0 else dim + _WIDTH if i == 4 else _WIDTH, _WIDTH)
           for i in range(8)]
    out += [("fc_feat", _WIDTH, _WIDTH), ("fc_alpha", _WIDTH, 1),
            ("layers_dir.0", _WIDTH, _DIR_WIDTH), ("layers_dir.1", _DIR_WIDTH, _DIR_WIDTH),
            ("layers_dir.2", _DIR_WIDTH, _DIR_WIDTH), ("fc_rgb", _DIR_WIDTH, 3)]
    return out


def num_params(num_freq: int) -> int:
    """Floats in the packed parameter buffer at encoding depth ``num_freq``."""
    return sum(_pad4(i * o) + _pad4(o) for _, i, o in layout(num_freq))


def pack_params(model: PaperNeRFModel) -> torch.Tensor:
    """The kernels' parameter buffer: each layer's (in, out) weight, then its
    bias, zero-padded, in ``layout``'s order. layers_dir.0 contributes its
    feat rows only. Differentiable: a ``torch.cat`` of the parameters."""
    parts = []
    for name, i, o in layout(model.num_encoding_fn_xyz):
        layer = model.get_submodule(name)
        w = layer.weight[:, :_WIDTH] if name == "layers_dir.0" else layer.weight
        for x in (w.t().reshape(-1), layer.bias):
            parts.append(x.float())
            if _pad4(x.numel()) != x.numel():
                parts.append(torch.zeros(_pad4(x.numel()) - x.numel(), device=x.device))
    return torch.cat(parts)


def unpack_params(params: torch.Tensor, num_freq: int
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Views of the packed buffer: name -> (weight (in, out), bias (out,))."""
    out, off = {}, 0
    for name, i, o in layout(num_freq):
        w = params[off:off + i * o].view(i, o)
        off += _pad4(i * o)
        out[name] = (w, params[off:off + o])
        off += _pad4(o)
    return out


def paper_plain_forward(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                        num_freq: int, compute_dtype: str = "float32", residuals: bool = True):
    """The kernels' forward in plain PyTorch: ``(raw (N, S, 4) f32,
    residuals)``, residuals = (enc, h0..h7, feat, d0, d1, d2), each (N*S, C)
    f32 holding values of the compute dtype (None with ``residuals=False``,
    which frees each trunk activation once the next exists). Differentiable
    in ``params`` and ``dc``."""
    r = _rounder(compute_dtype)
    layers = unpack_params(params.float(), num_freq)
    n, s = pts.shape[0], pts.shape[1]

    def dense(name, x):
        w, b = layers[name]
        return torch.addmm(b, x, r(w))

    enc = r(positional_encoding(pts.reshape(-1, 3).float(), num_freq))
    h, hs = enc, []
    for i in range(8):
        # layers_xyz.4 reads [enc, h3], the encoding first.
        h = r(torch.relu(dense(f"layers_xyz.{i}", torch.cat([enc, h], -1) if i == 4 else h)))
        if residuals:
            hs.append(h)
    feat = r(dense("fc_feat", h))                       # no ReLU
    sigma = dense("fc_alpha", feat)                     # from feat
    d = r(torch.relu(dense("layers_dir.0", feat) + dc.float().repeat_interleave(s, dim=0)))
    ds = [d]
    for i in (1, 2):                                    # layers_dir.3 is never run
        d = r(torch.relu(dense(f"layers_dir.{i}", d)))
        ds.append(d)
    rgb = dense("fc_rgb", d)
    out = torch.cat([rgb, sigma], dim=-1).reshape(n, s, 4)
    return out, (enc, *hs, feat, *ds) if residuals else None


def paper_t_plain(model: PaperNeRFModel, pts: torch.Tensor, viewdirs: torch.Tensor,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the kernel, same semantics: (N, S, 4) f32."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    return paper_plain_forward(pts, dir_contribution(model, viewdirs), pack_params(model),
                               model.num_encoding_fn_xyz, compute_dtype, residuals=False)[0]


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    lib = load_library()
    fn = lib.nerf_paper_t_forward
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, i64, ptr, i64, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    lib.nerf_paper_num_params.argtypes = [i32]
    lib.nerf_paper_num_params.restype = i32
    for f in (0, 6, 10):
        if lib.nerf_paper_num_params(f) != num_params(f):
            raise RuntimeError(f"csrc/paper_mlp.cuh layout at {f} frequencies "
                               f"({lib.nerf_paper_num_params(f)}) != wrapper's ({num_params(f)})")
    return fn


def fused_paper_mlp_t(model: PaperNeRFModel, pts: torch.Tensor, viewdirs: torch.Tensor,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """Radiance field of ``model`` at ``pts`` (N, S, 3) seen along ``viewdirs``
    (N, 3): (N, S, 4) raw [r, g, b, sigma] f32.

    CPU tensors go through ``paper_t_plain``. CUDA tensors go through the
    kernel; anything it does not take raises. ``fused_paper_mlp_t.launches``
    counts the kernel's launches.
    """
    what = "fused_paper_mlp_t"
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    if not supports_fused_paper(model):
        raise ValueError(f"{what}: model is not a PaperNeRF shape the kernel takes")
    if pts.device.type == "cpu":
        return paper_t_plain(model, pts, viewdirs, compute_dtype)
    if pts.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {pts.device}")
    if pts.ndim != 3 or pts.shape[-1] != 3 or tuple(viewdirs.shape) != (pts.shape[0], 3):
        raise ValueError(f"{what}: want pts (N, S, 3) and viewdirs (N, 3), got "
                         f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}")
    if pts.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise ValueError(f"{what}: pts and viewdirs must be float32")
    if viewdirs.device != pts.device or model.fc_feat.weight.device != pts.device:
        raise ValueError(f"{what}: pts, viewdirs and the model must share a device")

    n, s = pts.shape[0], pts.shape[1]
    out = torch.empty((n, s, 4), dtype=torch.float32, device=pts.device)
    if n * s == 0:
        return out
    # dc and params are freed when this returns, before the kernel may have
    # run: the caching allocator hands their blocks out again only in this
    # stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        pts_c = pts.contiguous()
        dc = _aligned(dir_contribution(model, viewdirs))
        params = _aligned(pack_params(model))
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = _kernel()(pts_c.data_ptr(), dc.data_ptr(), params.data_ptr(), params.numel(),
                       out.data_ptr(), n * s, s, model.num_encoding_fn_xyz,
                       int(compute_dtype == "bfloat16"), stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")
    fused_paper_mlp_t.launches += 1
    return out


fused_paper_mlp_t.launches = 0

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
10 frequencies against 28 B of point traffic. ``compute_dtype="float32"``
runs f32 FMAs from registers; ``"bfloat16"`` runs every wide product on the
tensor cores (``wgmma``, bf16 operands, f32 sums; ``csrc/paper_wg.cuh``), its
weights handed over as a bf16 image of the kernel's shared-memory ring
stages (``pack_wg_forward``), built once per call. ``pack_tc_forward`` packs
the same weights in ``mma.sync`` fragment order for #9's bf16 training
forward (``csrc/paper_tc.cuh``).

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
from .flex_train import _rounder
from .mlp import f32_matmul
from .mlp_t import _COMPUTE_DTYPES
from .train_vjp import aligned

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
    """Per-ray ``enc(viewdirs) @ W_dir[:, 256:].T``: (N, 3) -> (N, 128) f32,
    in full f32 on the card (``f32_matmul``: TF32 off for this product and
    its gradient only)."""
    direnc = positional_encoding(viewdirs.float(), model.num_encoding_fn_dir)
    return f32_matmul(direnc, model.layers_dir[0].weight[:, _WIDTH:].float().t())


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


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def fragment_order(m: torch.Tensor, warps: int = 8) -> torch.Tensor:
    """An (N, K) operand matrix (N a multiple of 16 ``warps``, K of 16)
    flattened in the order the tensor-core kernels read it
    (``csrc/tc_mma.cuh``): for each 16-deep k-step, for each of the ``warps``
    warps (N / warps consecutive outputs; 8 in the PaperNeRF kernels, 4 in the
    4x128 ones), for each lane l, the NT = N / (8 warps) m16n8k16 B fragments
    that lane holds: ``m[n][k]`` for n = (warp * NT + j) * 8 + l // 4 and
    k = 16 ks + 8 h + 2 (l % 4) + e, in (j, h, e) order."""
    n, k = m.shape
    x = m.reshape(warps, n // (8 * warps), 8, k // 16, 2, 4, 2)   # warp, j, l // 4, ks, h, l % 4, e
    return x.permute(3, 0, 2, 5, 1, 4, 6).reshape(-1)


def fragment_matrix(flat: torch.Tensor, n: int, k: int, warps: int = 8) -> torch.Tensor:
    """The inverse of ``fragment_order``: the (N, K) matrix."""
    x = flat.reshape(k // 16, warps, 8, 4, n // (8 * warps), 2, 2)
    return x.permute(1, 4, 2, 0, 5, 3, 6).reshape(n, k)


def _tc_forward_matrices(layers, dim: int, pad) -> List[Tuple[str, torch.Tensor]]:
    """The tensor-core forward's operands, in ``csrc/paper_tc.cuh``'s
    FwdLayout order: each wide layer as (out, in) with K padded to 16 by
    ``pad`` (layers_xyz.4: [enc rows, pad, h rows]), then fc_alpha (1, 256)
    and fc_rgb (3, 128), read plain."""
    kin = _pad16(dim)
    mats = []
    for i in range(8):
        w = layers[f"layers_xyz.{i}"][0].t()
        if i == 0:
            w = torch.nn.functional.pad(w, (0, kin - dim), value=pad)
        elif i == 4:
            enc_rows = torch.nn.functional.pad(w[:, :dim], (0, kin - dim), value=pad)
            w = torch.cat([enc_rows, w[:, dim:]], dim=1)
        mats.append((f"layers_xyz.{i}", w))
    return mats + [(name, layers[name][0].t()) for name in (
        "fc_feat", "layers_dir.0", "layers_dir.1", "layers_dir.2", "fc_alpha", "fc_rgb")]


def _flatten(mats, warps: int = 8) -> torch.Tensor:
    """The operand matrices (name, (N, K)) as one buffer: the wide ones (N of
    8 ``warps`` or more) in fragment order, the narrow heads row by row."""
    return torch.cat([fragment_order(m, warps) if m.shape[0] >= 8 * warps else m.reshape(-1)
                      for _, m in mats])


@functools.lru_cache(maxsize=None)
def _gather_index(matrices, num_freq: int, device: str) -> torch.Tensor:
    """Where each value of a bf16 weight buffer comes from in the packed
    parameters (``num_params`` for a zero pad), on ``device``: the packing,
    worked out once by running ``matrices`` on the positions themselves."""
    n = num_params(num_freq)
    ref = torch.arange(n + 1, dtype=torch.float64)
    flat = _flatten(matrices(unpack_params(ref, num_freq), 3 + 6 * num_freq, float(n)))
    return flat.long().to(device)


def gather_bf16(params: torch.Tensor, index) -> torch.Tensor:
    """A bf16 weight buffer from the packed f32 parameters (..., n), one a
    leading index (a scene): ``index(device)`` gives where each value comes
    from (n for a zero pad). One gather and one rounding, 16-byte aligned."""
    params = params.detach().float()
    ext = torch.nn.functional.pad(params, (0, 1))
    out = ext[..., index(str(params.device))].to(torch.bfloat16)
    return out if out.data_ptr() % 16 == 0 else out.clone()


def _gather_bf16(params: torch.Tensor, matrices, num_freq: int) -> torch.Tensor:
    """The bf16 weight buffer that ``matrices`` lays out at ``num_freq``."""
    return gather_bf16(params, lambda device: _gather_index(matrices, num_freq, device))


def pack_tc_forward(params: torch.Tensor, num_freq: int) -> torch.Tensor:
    """The bf16 forward kernels' weights (``csrc/paper_tc.cuh`` FwdLayout),
    from the packed parameters: every weight rounded to bf16, the wide ones
    in fragment order with zero K pads."""
    return _gather_bf16(params, _tc_forward_matrices, num_freq)


def unpack_tc_forward(buf: torch.Tensor, num_freq: int) -> Dict[str, torch.Tensor]:
    """``pack_tc_forward``'s buffer as f32 operand matrices: name -> (out,
    in) with its K pads."""
    return _unflatten(buf, _tc_forward_matrices(
        unpack_params(torch.zeros(num_params(num_freq)), num_freq), 3 + 6 * num_freq, 0.0))


_SLICE_K = 64   # K columns of a ring slice of the wgmma kernel (csrc/paper_wg.cuh kSliceK)


def _swizzled(m: torch.Tensor, pad: float) -> torch.Tensor:
    """An (N, K) operand as the shared-memory images of its ring slices
    (``csrc/paper_wg.cuh``): K cut into 64-column slices, the last padded
    with ``pad``; each slice N rows of 128 bytes, K-major, whose eight
    16-byte chunks lie swizzled: column k of row n in chunk (k // 8) ^ (n % 8),
    the layout wgmma's 128-byte-swizzle descriptor reads."""
    n, k = m.shape
    kp = -(-k // _SLICE_K) * _SLICE_K
    x = torch.nn.functional.pad(m, (0, kp - k), value=pad).reshape(n, kp // _SLICE_K, 8, 8)
    rows = torch.arange(n).view(n, 1)
    x = x[rows, :, torch.arange(8).view(1, 8) ^ (rows % 8)]     # n, chunk, slice, e
    return x.permute(2, 0, 1, 3).reshape(-1)


def _unswizzled(flat: torch.Tensor, n: int, k: int) -> torch.Tensor:
    """The inverse of ``_swizzled``: the (N, K) matrix, the slices' pads cut."""
    kp = -(-k // _SLICE_K) * _SLICE_K
    x = flat.reshape(kp // _SLICE_K, n, 8, 8).permute(1, 0, 2, 3)   # n, slice, chunk, e
    rows = torch.arange(n).view(n, 1)
    x = x[rows, :, torch.arange(8).view(1, 8) ^ (rows % 8)]         # n, chunk, slice, e
    return x.permute(0, 2, 1, 3).reshape(n, kp)[:, :k]


def _wg_parts(mats) -> List[Tuple[str, torch.Tensor]]:
    """The wgmma kernel's operands in the order its ring reads them: the
    tensor-core forward's matrices (``_tc_forward_matrices``) with layer 4
    cut into its encoding rows and its h rows (each starts a slice)."""
    kin = mats[0][1].shape[1]
    out = []
    for name, m in mats:
        if name == "layers_xyz.4":
            out += [(f"{name}.enc", m[:, :kin]), (f"{name}.h", m[:, kin:])]
        else:
            out.append((name, m))
    return out


def _wg_image(mats, pad: float) -> torch.Tensor:
    """``_tc_forward_matrices``' operands as the wgmma kernel's weight image:
    every wide one as its swizzled ring slices (``_swizzled``), in order,
    then the narrow heads fc_alpha and fc_rgb row by row."""
    return torch.cat([_swizzled(m, pad) if m.shape[0] >= _DIR_WIDTH else m.reshape(-1)
                      for _, m in _wg_parts(mats)])


@functools.lru_cache(maxsize=None)
def _wg_index(num_freq: int, device: str) -> torch.Tensor:
    """Where each value of ``pack_wg_forward``'s image comes from in the packed
    parameters (``num_params`` for a zero pad), on ``device``."""
    n = num_params(num_freq)
    ref = torch.arange(n + 1, dtype=torch.float64)
    mats = _tc_forward_matrices(unpack_params(ref, num_freq), 3 + 6 * num_freq, float(n))
    return _wg_image(mats, float(n)).long().to(device)


def pack_wg_forward(params: torch.Tensor, num_freq: int) -> torch.Tensor:
    """The bf16 render forward's weights (``csrc/paper_wg.cuh``), from the
    packed parameters: every weight rounded to bf16, each wide layer (out,
    in) as the swizzled images of its 64-column K slices in the order the
    kernel's ring streams them (K pads zero: 63 -> 64, the skip's encoding
    rows and h rows each a whole number of slices), then fc_alpha and
    fc_rgb plain."""
    return gather_bf16(params, lambda device: _wg_index(num_freq, device))


def unpack_wg_forward(buf: torch.Tensor, num_freq: int) -> Dict[str, torch.Tensor]:
    """``pack_wg_forward``'s image as f32 operand matrices, in
    ``unpack_tc_forward``'s form: name -> (out, in) with its pads to 16
    (layers_xyz.4: [enc rows, pad, h rows]). Raises if a slice's pad beyond
    those is not zero."""
    mats = _tc_forward_matrices(unpack_params(torch.zeros(num_params(num_freq)), num_freq),
                                3 + 6 * num_freq, 0.0)
    got, off = {}, 0
    for name, m in _wg_parts(mats):
        n, k = m.shape
        size = n * (-(-k // _SLICE_K) * _SLICE_K if n >= _DIR_WIDTH else k)
        part = buf[off:off + size].float()
        if n >= _DIR_WIDTH:
            whole = _unswizzled(part, n, -(-k // _SLICE_K) * _SLICE_K)
            if whole[:, k:].any():
                raise ValueError(f"{name}: nonzero values in its slices' pad")
            got[name] = whole[:, :k]
        else:
            got[name] = part.view(n, k)
        off += size
    if off != buf.numel():
        raise ValueError(f"a buffer of {buf.numel()} values for a layout of {off}")
    got["layers_xyz.4"] = torch.cat([got.pop("layers_xyz.4.enc"), got.pop("layers_xyz.4.h")], 1)
    return got


def wg_forward_weights(num_freq: int) -> int:
    """bf16 values of ``pack_wg_forward``'s image."""
    return _wg_index(num_freq, "cpu").numel()


def _unflatten(buf: torch.Tensor, mats, warps: int = 8) -> Dict[str, torch.Tensor]:
    """The inverse of ``_flatten``: name -> the f32 (N, K) matrix."""
    out, off = {}, 0
    for name, m in mats:
        n, k = m.shape
        part = buf[off:off + n * k].float()
        out[name] = fragment_matrix(part, n, k, warps) if n >= 8 * warps else part.view(n, k)
        off += n * k
    if off != buf.numel():
        raise ValueError(f"a buffer of {buf.numel()} values for a layout of {off}")
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
    fn.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr, i64, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    for name in ("nerf_paper_num_params", "nerf_paper_wg_weights"):
        getattr(lib, name).argtypes = [i32]
        getattr(lib, name).restype = i32
    for f in (0, 6, 10, 16):
        got = (lib.nerf_paper_num_params(f), lib.nerf_paper_wg_weights(f))
        want = (num_params(f), wg_forward_weights(f))
        if got != want:
            raise RuntimeError(f"csrc/paper_mlp.cuh / paper_wg.cuh layouts at {f} frequencies "
                               f"{got} != wrapper's {want}")
    return fn


def tc_forward_weights(num_freq: int) -> int:
    """bf16 values of ``pack_tc_forward``'s buffer."""
    return _gather_index(_tc_forward_matrices, num_freq, "cpu").numel()


def fused_paper_mlp_t(model: PaperNeRFModel, pts: torch.Tensor, viewdirs: torch.Tensor,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """Radiance field of ``model`` at ``pts`` (N, S, 3) seen along ``viewdirs``
    (N, 3): (N, S, 4) raw [r, g, b, sigma] f32.

    CPU tensors go through ``paper_t_plain``. CUDA tensors go through the
    kernel; anything it does not take raises. ``fused_paper_mlp_t.launches``
    counts the kernel's launches, ``fused_paper_mlp_t.wgmma_launches`` those
    of its bf16 instance (``csrc/paper_wg.cuh``).
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
    # dc, params and wbf are freed when this returns, before the kernel may
    # have run: the caching allocator hands their blocks out again only in
    # this stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        pts_c = pts.contiguous()
        dc = aligned(dir_contribution(model, viewdirs))
        params = aligned(pack_params(model))
        f = model.num_encoding_fn_xyz
        wbf = pack_wg_forward(params, f) if compute_dtype == "bfloat16" else None
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = _kernel()(pts_c.data_ptr(), dc.data_ptr(), params.data_ptr(), params.numel(),
                       None if wbf is None else wbf.data_ptr(), 0 if wbf is None else wbf.numel(),
                       out.data_ptr(), n * s, s, f, int(wbf is not None), stream)
    if rc != 0:
        raise RuntimeError(f"{what}: kernel launch failed with CUDA error {rc}")
    fused_paper_mlp_t.launches += 1
    fused_paper_mlp_t.wgmma_launches += wbf is not None
    return out


fused_paper_mlp_t.launches = 0
fused_paper_mlp_t.wgmma_launches = 0

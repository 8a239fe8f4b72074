"""The 4x128 FlexibleNeRF field's fused forwards, point-major and ray-major.

Replaces ``nerf_tpu/ops/pallas/mlp.py``'s ``fused_flexible_mlp`` (points
(N, 3) with one view direction each -> (N, 4)) and
``fused_flexible_mlp_rays`` ((R, S, 3) points + (R, 3) ray directions ->
(R, S, 4)) with hand-written CUDA kernels for Hopper (``csrc/mlp.cu``): raw
[r, g, b, sigma] f32, the positional encoding, the trunk, fc_feat/fc_alpha,
the direction layer and fc_rgb in one launch whose activations stay in
shared memory and registers.

What bounds them on the card is arithmetic: ~82k multiply-adds per point
(the point-major one 27 x 64 more) against 24-28 B of point traffic. In f32
both run ``csrc/flex_mlp.cuh``'s forward, the one ``kernels/mlp_t.py``'s
kernel runs, on f32 FMAs; only the direction layer differs. The point-major
kernel encodes each point's direction itself and sums its 27 direction rows
into the direction layer, as the TPU kernel does. The ray-major one adds the
per-ray contribution ``enc(viewdirs) @ W_dir[128:]`` (R, 64), made outside
the kernel with one matmul, from a copy in shared memory: it computes what
``fused_mlp_t`` computes, bit for bit. In bf16 both run
``csrc/flex_tc.cuh``'s ``mma.sync`` tile: the ray-major one on the weights
``pack_tc_forward`` builds, again bit for bit ``fused_mlp_t``'s bf16 body
(``csrc/flex_wg.cuh`` on wgmma, which sums in the tile's order); the
point-major one with its own direction layer, on the weights
``pack_tc_forward_points`` builds.

This module also holds what the family's kernels share, as the JAX
package's ``mlp.py`` does: the shape gate ``supports_fused``, the packed
parameter layout, the per-ray direction contribution, and the bf16 forward
weights of the tensor-core kernels (``pack_tc_forward``: the bf16 instances
of the training forward, ``fused_render_stage`` and the ray-major forward
run ``csrc/flex_tc.cuh``; ``pack_tc_forward_points`` for the point-major
one; ``pack_wg_forward``: ``fused_mlp_t``'s, ``csrc/flex_wg.cuh``).

``compute_dtype="bfloat16"`` rounds both operands of every matmul to bf16
and keeps f32 sums (``preferred_element_type=f32``). The point-major kernel
rounds its direction encoding and the direction rows of W_dir too; the
ray-major one keeps the direction contribution f32. The plain versions
``flexible_mlp_plain`` and ``flexible_mlp_rays_plain`` emulate exactly that
with ``.bfloat16().float()`` and f32 matmuls.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from typing import Dict, Tuple

import torch

from ..models.mlp import FlexibleNeRFModel
from ..ops.encoding import positional_encoding

_NUM_FREQ_XYZ = 10
_NUM_FREQ_DIR = 4
_DIM_XYZ = 3 + 6 * _NUM_FREQ_XYZ   # 63
_DIM_DIR = 3 + 6 * _NUM_FREQ_DIR   # 27
_DIR_K = 32                        # _DIM_DIR padded to a k-step of the tensor cores
_HIDDEN = 128
_DIR_HIDDEN = 64
_COMPUTE_DTYPES = ("float32", "bfloat16")
_TC_WARPS = 4              # warps of a tensor-core block (csrc/flex_tc.cuh kWarps)

# Packed parameter buffer (pack_params, csrc/flex_mlp.cuh): name -> (in, out)
# of each weight, then its bias (out,).
_LAYOUT = (
    ("layer1", _DIM_XYZ, _HIDDEN),
    ("layers_xyz.0", _HIDDEN, _HIDDEN),
    ("layers_xyz.1", _HIDDEN, _HIDDEN),
    ("layers_xyz.2", _HIDDEN, _HIDDEN),
    ("fc_feat", _HIDDEN, _HIDDEN),
    ("fc_alpha", _HIDDEN, 1),
    ("layers_dir.0", _HIDDEN, _DIR_HIDDEN),
    ("fc_rgb", _DIR_HIDDEN, 3),
)
_NUM_PARAMS = sum(i * o + o for _, i, o in _LAYOUT)      # 82820
_NUM_PARAMS_POINTS = _NUM_PARAMS + _DIM_DIR * _DIR_HIDDEN  # 84548, pack_params_points


def supports_fused(model) -> bool:
    """True when ``model`` is the default FlexibleNeRF shape the kernels fuse
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


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for the matmuls inside; the caller's setting is restored."""
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


class _F32MatMul(torch.autograd.Function):
    # vmap (the multi-scene step's scene axis) runs the forward and the
    # backward below on batched tensors.
    generate_vmap_rule = True

    @staticmethod
    def forward(a, b):
        with _no_tf32():
            return a @ b

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(*inputs)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        with _no_tf32():
            return (g @ b.t() if ctx.needs_input_grad[0] else None,
                    a.t() @ g if ctx.needs_input_grad[1] else None)


def f32_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` in full float32 on the card, forward and gradient, whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says: the JAX package asks for
    HIGHEST precision per dot, so the flag is turned off around these
    products only and the caller's setting is kept."""
    return _F32MatMul.apply(a, b)


def dir_contribution(model: FlexibleNeRFModel, viewdirs: torch.Tensor) -> torch.Tensor:
    """Per-ray ``enc(viewdirs) @ W_dir[128:]``: (N, 3) -> (N, 64) f32, in
    full f32 on the card (``f32_matmul``)."""
    direnc = positional_encoding(viewdirs.float(), _NUM_FREQ_DIR)      # (N, 27)
    w_dir = model.layers_dir[0].weight[:, _HIDDEN:].float()           # (64, 27)
    return f32_matmul(direnc, w_dir.t())


def pack_params(model: FlexibleNeRFModel) -> torch.Tensor:
    """The kernels' parameter buffer: each layer's (in, out) weight, then its
    bias, in the order of the offsets in ``csrc/flex_mlp.cuh`` (layers_dir.0's
    feature rows only)."""
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


def pack_params_points(model: FlexibleNeRFModel) -> torch.Tensor:
    """The point-major kernel's buffer: ``pack_params`` followed by
    layers_dir.0's direction rows (27, 64)."""
    w_dir = model.layers_dir[0].weight[:, _HIDDEN:].t()
    return torch.cat([pack_params(model), w_dir.float().reshape(-1)])


def unpack_params(params: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Views of the packed buffer: name -> (weight (in, out), bias (out,))."""
    out, off = {}, 0
    for name, i, o in _LAYOUT:
        out[name] = (params[off:off + i * o].view(i, o), params[off + i * o:off + i * o + o])
        off += i * o + o
    return out


def unpack_params_points(params: torch.Tensor) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Views of ``pack_params_points``' buffer: ``unpack_params``' layers and
    "dir_rows" -> (layers_dir.0's direction rows (27, 64), None)."""
    out = unpack_params(params)
    out["dir_rows"] = (params[_NUM_PARAMS:_NUM_PARAMS_POINTS].view(_DIM_DIR, _DIR_HIDDEN), None)
    return out


def _tc_forward_matrices(layers, pad):
    """The tensor-core forward's operands, in ``csrc/flex_tc.cuh``'s kW*
    order, each (out, in): layer1 with K 63 -> 64 (the pad holds ``pad``),
    layers_xyz.0 .. .2, fc_feat, layers_dir.0's feat rows, then fc_alpha
    (1, 128) and fc_rgb (3, 64), read plain."""
    def w(name):
        return layers[name][0].t()

    return [("layer1", torch.nn.functional.pad(w("layer1"), (0, 1), value=pad))] + [
        (name, w(name)) for name in ("layers_xyz.0", "layers_xyz.1", "layers_xyz.2", "fc_feat",
                                     "layers_dir.0", "fc_alpha", "fc_rgb")]


def _tc_forward_points_matrices(layers, pad):
    """``_tc_forward_matrices``, then layers_dir.0's direction rows as (64,
    in) with K 27 -> 32 (the pads hold ``pad``): the point-major kernel's
    operands (``csrc/flex_tc.cuh`` kWdDir)."""
    dirs = torch.nn.functional.pad(layers["dir_rows"][0].t(), (0, _DIR_K - _DIM_DIR), value=pad)
    return _tc_forward_matrices(layers, pad) + [("dir_rows", dirs)]


def _unpacker(points: bool):
    """(unpack, number of values) of the packed parameters: ``pack_params``'
    layout, or with ``points`` ``pack_params_points``'."""
    return (unpack_params_points, _NUM_PARAMS_POINTS) if points else (unpack_params, _NUM_PARAMS)


@functools.lru_cache(maxsize=None)
def tc_gather_index(matrices, device: str, points: bool = False) -> torch.Tensor:
    """Where each value of a 4x128 bf16 weight buffer comes from in the
    packed parameters (``pack_params``', or with ``points``
    ``pack_params_points``'; one past their last value for a zero pad), on
    ``device``: ``matrices`` run on the positions themselves, flattened for
    4-warp blocks."""
    from .paper_t import _flatten

    unpack, n = _unpacker(points)
    ref = torch.arange(n + 1, dtype=torch.float64)
    return _flatten(matrices(unpack(ref), float(n)), _TC_WARPS).long().to(device)


def tc_unflatten(buf: torch.Tensor, matrices, points: bool = False) -> Dict[str, torch.Tensor]:
    """A 4x128 bf16 weight buffer as f32 operand matrices: name -> (N, K)
    with its K pads (``points``: the layout ``tc_gather_index`` takes)."""
    from .paper_t import _unflatten

    unpack, n = _unpacker(points)
    return _unflatten(buf, matrices(unpack(torch.zeros(n)), 0.0), _TC_WARPS)


def pack_tc_forward(params: torch.Tensor) -> torch.Tensor:
    """The bf16 forward kernels' weights (``csrc/flex_tc.cuh`` kW*), from
    the packed parameters: every weight rounded to bf16, the wide ones in
    fragment order with zero K pads (``kernels/paper_t.fragment_order`` at 4
    warps)."""
    from .paper_t import gather_bf16

    return gather_bf16(params, lambda device: tc_gather_index(_tc_forward_matrices, device))


def unpack_tc_forward(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``pack_tc_forward``'s buffer as f32 operand matrices: name -> (out,
    in) with its K pads."""
    return tc_unflatten(buf, _tc_forward_matrices)


def pack_tc_forward_points(params: torch.Tensor) -> torch.Tensor:
    """The bf16 point-major kernel's weights, from ``pack_params_points``'
    buffer: ``pack_tc_forward``'s buffer, then layers_dir.0's 27 direction
    rows padded with zero rows to 32, in fragment order."""
    from .paper_t import gather_bf16

    return gather_bf16(params, lambda device: tc_gather_index(_tc_forward_points_matrices,
                                                              device, points=True))


def unpack_tc_forward_points(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``pack_tc_forward_points``' buffer as f32 operand matrices:
    ``unpack_tc_forward``'s and "dir_rows" (64, 32)."""
    return tc_unflatten(buf, _tc_forward_points_matrices, points=True)


def _wg_image(mats) -> torch.Tensor:
    """The tensor-core forward's operands (``_tc_forward_matrices``, (out,
    in)) as the wgmma body's weight image (``csrc/flex_wg.cuh``): each wide
    layer as the swizzled images of its 64-column K slices
    (``kernels/paper_t._swizzled``), in order, then fc_alpha and fc_rgb row
    by row."""
    from .paper_t import _swizzled

    return torch.cat([_swizzled(m, 0.0) if m.shape[0] >= _DIR_HIDDEN else m.reshape(-1)
                      for _, m in mats])


@functools.lru_cache(maxsize=None)
def wg_gather_index(device: str) -> torch.Tensor:
    """Where each value of ``pack_wg_forward``'s image comes from in
    ``pack_params``' buffer (one past its last value for a zero pad), on
    ``device``."""
    ref = torch.arange(_NUM_PARAMS + 1, dtype=torch.float64)
    return _wg_image(_tc_forward_matrices(unpack_params(ref), float(_NUM_PARAMS))).long().to(
        device)


def pack_wg_forward(params: torch.Tensor) -> torch.Tensor:
    """#1's bf16 weights (``csrc/flex_wg.cuh``), from the packed parameters:
    every weight rounded to bf16, each wide layer (out, in) as the swizzled
    shared-memory images of its 64-column K slices (layer1's K 63 -> 64 with
    a zero row), then fc_alpha and fc_rgb plain. The layers lie at
    ``pack_tc_forward``'s offsets; only the order inside each differs."""
    from .paper_t import gather_bf16

    return gather_bf16(params, wg_gather_index)


def unpack_wg_forward(buf: torch.Tensor) -> Dict[str, torch.Tensor]:
    """``pack_wg_forward``'s image as f32 operand matrices, in
    ``unpack_tc_forward``'s form: name -> (out, in) with its K pads."""
    from .paper_t import _unswizzled

    got, off = {}, 0
    for name, m in _tc_forward_matrices(unpack_params(torch.zeros(_NUM_PARAMS)), 0.0):
        n, k = m.shape
        part = buf[off:off + n * k].float()
        got[name] = _unswizzled(part, n, k) if n >= _DIR_HIDDEN else part.view(n, k)
        off += n * k
    if off != buf.numel():
        raise ValueError(f"a buffer of {buf.numel()} values for a layout of {off}")
    return got


def wg_forward_weights() -> int:
    """bf16 values of ``pack_wg_forward``'s image."""
    return wg_gather_index("cpu").numel()


def _rounding(compute_dtype: str):
    """x -> x rounded to the matmul input dtype, kept f32."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    if compute_dtype == "bfloat16":
        return lambda x: x.bfloat16().float()
    return lambda x: x


def _dense(layer, x, r, cols=None):
    w = layer.weight if cols is None else layer.weight[:, cols]
    return r(x) @ r(w.float()).t() + layer.bias.float()


def _trunk_plain(model, pts, r):
    """(feat, sigma) of the points (..., 3)."""
    h = _dense(model.layer1, positional_encoding(pts.float(), _NUM_FREQ_XYZ), r)
    for layer in model.layers_xyz:
        h = torch.relu(_dense(layer, h, r))
    return torch.relu(_dense(model.fc_feat, h, r)), _dense(model.fc_alpha, h, r)


def flexible_mlp_rays_plain(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Plain PyTorch version of the ray-major kernel (and of ``fused_mlp_t``,
    which computes the same function): (R, S, 4) f32."""
    r = _rounding(compute_dtype)
    dc = dir_contribution(model, viewdirs)                          # (R, 64)
    feat, sigma = _trunk_plain(model, pts, r)
    hd = torch.relu(
        _dense(model.layers_dir[0], feat, r, cols=slice(0, _HIDDEN)) + dc[:, None, :]
    )
    return torch.cat([_dense(model.fc_rgb, hd, r), sigma], dim=-1)


def flexible_mlp_plain(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Plain PyTorch version of the point-major kernel: (N, 4) f32. In
    bfloat16 the direction encoding and W_dir's direction rows are rounded
    too, as the kernel rounds them."""
    r = _rounding(compute_dtype)
    feat, sigma = _trunk_plain(model, pts, r)
    layer = model.layers_dir[0]
    w = layer.weight.float()
    direnc = positional_encoding(viewdirs.float(), _NUM_FREQ_DIR)   # (N, 27)
    hd = torch.relu(r(feat) @ r(w[:, :_HIDDEN]).t() + r(direnc) @ r(w[:, _HIDDEN:]).t()
                    + layer.bias.float())
    return torch.cat([_dense(model.fc_rgb, hd, r), sigma], dim=-1)


@functools.lru_cache(maxsize=None)
def _kernels():
    from ._build import load_library

    lib = load_library()
    points = lib.nerf_flexible_mlp_forward
    points.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                               ctypes.c_longlong, ctypes.c_void_p,
                                               ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
    rays = lib.nerf_flexible_mlp_rays_forward
    rays.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_void_p,
                                             ctypes.c_longlong, ctypes.c_void_p,
                                             ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p]
    points.restype = rays.restype = ctypes.c_int
    return points, rays


def _check(name: str, model, pts: torch.Tensor, compute_dtype: str):
    """The checks both wrappers make before choosing a path."""
    if compute_dtype not in _COMPUTE_DTYPES:
        raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
    if not supports_fused(model):
        raise ValueError(f"{name}: model is not the 4x128 10/4 FlexibleNeRF shape")
    if pts.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no kernel for device {pts.device}")


def _check_cuda(name: str, model, pts: torch.Tensor, viewdirs: torch.Tensor):
    if pts.dtype != torch.float32 or viewdirs.dtype != torch.float32:
        raise ValueError(f"{name}: pts and viewdirs must be float32")
    if viewdirs.device != pts.device or model.layer1.weight.device != pts.device:
        raise ValueError(f"{name}: pts, viewdirs and the model must share a device")


def fused_flexible_mlp(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Radiance field of ``model`` at points ``pts`` (N, 3), each seen along
    its own ``viewdirs`` row (N, 3): (N, 4) raw [r, g, b, sigma] f32.

    CPU tensors go through ``flexible_mlp_plain``. CUDA tensors go through
    the kernel; anything it does not take raises.
    ``fused_flexible_mlp.launches`` counts the kernel's launches.
    """
    _check("fused_flexible_mlp", model, pts, compute_dtype)
    if pts.device.type == "cpu":
        return flexible_mlp_plain(model, pts, viewdirs, compute_dtype)
    if pts.ndim != 2 or pts.shape[-1] != 3 or tuple(viewdirs.shape) != tuple(pts.shape):
        raise ValueError(
            f"fused_flexible_mlp: want pts (N, 3) and viewdirs (N, 3), got "
            f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}"
        )
    _check_cuda("fused_flexible_mlp", model, pts, viewdirs)
    n = pts.shape[0]
    out = torch.empty((n, 4), dtype=torch.float32, device=pts.device)
    if n == 0:
        return out
    # params and wbf are freed when this returns, before the kernel may have
    # run: the caching allocator hands their blocks out again only in this
    # stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        pts_c, vd_c = pts.contiguous(), viewdirs.contiguous()
        params = pack_params_points(model).contiguous()
        wbf = pack_tc_forward_points(params) if compute_dtype == "bfloat16" else None
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = _kernels()[0](
            pts_c.data_ptr(), vd_c.data_ptr(), params.data_ptr(), params.numel(),
            None if wbf is None else wbf.data_ptr(), 0 if wbf is None else wbf.numel(),
            out.data_ptr(), n, int(wbf is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_flexible_mlp: kernel launch failed with CUDA error {rc}")
    fused_flexible_mlp.launches += 1
    return out


fused_flexible_mlp.launches = 0


def fused_flexible_mlp_rays(
    model: FlexibleNeRFModel,
    pts: torch.Tensor,
    viewdirs: torch.Tensor,
    compute_dtype: str = "float32",
) -> torch.Tensor:
    """Radiance field of ``model`` at ``pts`` (R, S, 3), the samples of rays
    seen along ``viewdirs`` (R, 3): (R, S, 4) raw [r, g, b, sigma] f32.

    CPU tensors go through ``flexible_mlp_rays_plain``. CUDA tensors go
    through the kernel; anything it does not take raises.
    ``fused_flexible_mlp_rays.launches`` counts the kernel's launches.
    """
    _check("fused_flexible_mlp_rays", model, pts, compute_dtype)
    if pts.device.type == "cpu":
        return flexible_mlp_rays_plain(model, pts, viewdirs, compute_dtype)
    if pts.ndim != 3 or pts.shape[-1] != 3 or tuple(viewdirs.shape) != (pts.shape[0], 3):
        raise ValueError(
            f"fused_flexible_mlp_rays: want pts (R, S, 3) and viewdirs (R, 3), got "
            f"{tuple(pts.shape)} and {tuple(viewdirs.shape)}"
        )
    _check_cuda("fused_flexible_mlp_rays", model, pts, viewdirs)
    r, s = pts.shape[0], pts.shape[1]
    out = torch.empty((r, s, 4), dtype=torch.float32, device=pts.device)
    if r * s == 0:
        return out
    # dc, params and wbf are freed when this returns, before the kernel may
    # have run: see fused_flexible_mlp.
    with torch.no_grad(), torch.cuda.device(pts.device):
        pts_c = pts.contiguous()
        dc = dir_contribution(model, viewdirs).contiguous()
        params = pack_params(model).contiguous()
        wbf = pack_tc_forward(params) if compute_dtype == "bfloat16" else None
        stream = torch.cuda.current_stream(pts.device).cuda_stream
        rc = _kernels()[1](
            pts_c.data_ptr(), dc.data_ptr(), params.data_ptr(), params.numel(),
            None if wbf is None else wbf.data_ptr(), 0 if wbf is None else wbf.numel(),
            out.data_ptr(), r * s, s, int(wbf is not None), stream,
        )
    if rc != 0:
        raise RuntimeError(f"fused_flexible_mlp_rays: kernel launch failed with CUDA error {rc}")
    fused_flexible_mlp_rays.launches += 1
    return out


fused_flexible_mlp_rays.launches = 0

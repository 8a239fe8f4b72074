"""Fused FlexibleNeRF (4x128, 10/4) training kernels: forward + backward.

Replaces ``nerf_tpu/ops/pallas/flex_train.py:fused_flex_mlp_train`` (the
custom-VJP pair that ``train_vjp.py:build_train_vjp`` builds; ``pallas_call``
at ``train_vjp.py:197`` forward and ``:241`` backward) with two hand-written
CUDA kernels for Hopper in ``csrc/flex_train.cu``, behind one
``torch.autograd.Function`` (``kernels/train_vjp.py``):

- forward: ``mlp_t``'s evaluation (N, S, 3) + dc (N, 64) -> (N, S, 4) raw
  f32, saving the residuals in the compute dtype: enc, a0 (layer1's output,
  not ReLU'd), h1, h2, h3, feat and hd (post-ReLU);
- backward: (N, S, 4) f32 cotangent + residuals -> the gradient of the
  packed parameter buffer (``kernels/mlp.pack_params``'s layout: every
  weight and bias but the viewdir columns of ``layers_dir[0]``) and ddc
  (N, 64), the gradient of the per-ray direction contribution. Four
  launches (layer gradients, weight gradients per chunk of points, a
  fixed-order sum over chunks, ddc per ray): deterministic, no atomics.

``compute_dtype="float32"`` runs both on f32 FMAs; ``"bfloat16"`` runs the
forward, the layer gradients and the weight gradients on the tensor cores
(``mma.sync``, bf16 operands, f32 sums; ``csrc/flex_tc.cuh``), with bf16
copies of the weights in the instruction's fragment order
(``kernels/mlp.IMAGES``' ``tc_forward`` and ``tc_backward``) built once per
call, and bf16 residuals point-major (``residuals_as_plain`` reads either layout).

``flex_train_plain_fwd`` / ``flex_train_plain_bwd`` are the plain PyTorch
version: the same residuals and the same gradients from them, by the
hand-derived backward. CPU tensors take them; CUDA tensors take the kernels
or raise. With ``compute_dtype="bfloat16"`` both operands of every product
are rounded to bf16 and the sums stay f32 (``.bfloat16().float()`` and f32
matmuls in the plain version); bias gradients and ddc sum the unrounded f32
gradients, as the TPU kernel does.

``flex_train_fwd_scenes`` / ``flex_train_bwd_scenes`` run S scenes of one shape, each
with its own parameters, in one launch each way (the scene is a grid axis
of every pass, ``csrc/scenes.cuh``): the autograd function's ``vmap`` rule
calls them for the multi-scene step. ``flex_train_fwd`` / ``flex_train_bwd`` are
their S = 1 case, which launches the single-scene kernels.

``fused_flex_mlp_train.fwd_launches`` and ``.bwd_launches`` count the
kernels' launches (one per call each, a scene-batched call included).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..ops.encoding import positional_encoding
from .common import rounder
from .mlp import (
    _DIM_XYZ,
    _DIR_HIDDEN,
    _HIDDEN,
    _LAYOUT,
    _NUM_FREQ_XYZ,
    _NUM_PARAMS,
    IMAGES,
    dir_contribution,
    pack_params,
    supports_fused,
    unpack_params,
)
from .train_vjp import (
    TrainKernelFamily,
    TrainLaunches,
    TrainLayout,
    build_train_vjp,
    launch_backward,
    launch_forward,
    plain_backward_scenes,
    plain_forward_scenes,
)

_TILE = 64                 # points per block (csrc/flex_mlp.cuh kTile)
_TILES_PER_CHUNK = 16      # point tiles per weight-gradient block
_RES_ROWS = _DIM_XYZ + 5 * _HIDDEN + _DIR_HIDDEN          # 767 residual rows per point
_TC_RES_ROWS = 64 + 5 * _HIDDEN + _DIR_HIDDEN             # 768 in bf16, enc padded to 64
_DELTA_ROWS = 4 + _DIR_HIDDEN + 5 * _HIDDEN               # 708 f32 gradient rows per point


def residuals_as_plain(residuals, n_points: int, compute_dtype: str = "float32"):
    """``flex_train_fwd``'s residuals as views in the plain version's form,
    (enc, a0, h1, h2, h3, feat, hd), each (n_points, C) in the compute dtype:
    the plain backward run on the forward kernel's own residuals is the
    backward kernel's plain version on the same inputs. The kernel's f32
    buffer is res[tile][row][point], its bf16 one res[point][row] with enc
    padded to 64; the plain forward's (CPU) residuals are returned as they
    are."""
    if len(residuals) != 1:
        return tuple(residuals)
    (res,) = residuals
    if compute_dtype == "bfloat16":
        table, kin = res.view(-1, _TC_RES_ROWS)[:n_points], 64
    else:
        table = res.view(-1, _RES_ROWS, _TILE).transpose(1, 2).reshape(-1, _RES_ROWS)[:n_points]
        kin = _DIM_XYZ
    widths = [_DIM_XYZ] + [_HIDDEN] * 5 + [_DIR_HIDDEN]
    starts = [0] + [kin + _HIDDEN * i for i in range(6)]
    return tuple(table[:, a:a + w] for a, w in zip(starts, widths))


def flex_train_plain_fwd(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                         compute_dtype: str = "float32"):
    """Plain version of the forward kernel: ``(raw (N, S, 4) f32, residuals)``,
    residuals = (enc, a0, h1, h2, h3, feat, hd), each (N*S, C) in the compute
    dtype."""
    r = rounder(compute_dtype)
    layers = unpack_params(params.float())
    n, s = pts.shape[0], pts.shape[1]

    def dense(name, x):
        w, b = layers[name]
        return x @ r(w) + b

    enc = r(positional_encoding(pts.reshape(-1, 3).float(), _NUM_FREQ_XYZ))
    a0 = r(dense("layer1", enc))                       # layer1: no ReLU
    h1 = r(torch.relu(dense("layers_xyz.0", a0)))
    h2 = r(torch.relu(dense("layers_xyz.1", h1)))
    h3 = r(torch.relu(dense("layers_xyz.2", h2)))
    feat = r(torch.relu(dense("fc_feat", h3)))
    sigma = dense("fc_alpha", h3)
    hd = r(torch.relu(dense("layers_dir.0", feat) + dc.float().repeat_interleave(s, dim=0)))
    rgb = dense("fc_rgb", hd)
    out = torch.cat([rgb, sigma], dim=-1).reshape(n, s, 4)
    store = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    return out, tuple(x.to(store) for x in (enc, a0, h1, h2, h3, feat, hd))


def flex_train_plain_bwd(g: torch.Tensor, residuals, params: torch.Tensor, n: int, s: int,
                         compute_dtype: str = "float32"):
    """Plain version of the backward kernel: ``(d params (82820,) in the
    packed layout, ddc (N, 64))`` from the cotangent and the residuals."""
    r = rounder(compute_dtype)
    layers = unpack_params(params.float())
    enc, a0, h1, h2, h3, feat, hd = (x.float() for x in residuals)
    g = g.reshape(-1, 4).float()
    drgb, dsigma = g[:, :3], g[:, 3:]

    def back(dy, name, mask=None):
        # dX = dY W^T (W stored (in, out)), masked where the stored
        # post-ReLU activation is not positive.
        dx = r(dy) @ r(layers[name][0]).t()
        return dx if mask is None else torch.where(mask > 0, dx, torch.zeros_like(dx))

    dhd = back(drgb, "fc_rgb", hd)
    dfeat = back(dhd, "layers_dir.0", feat)
    # The fused head: [dfeat; dsigma] against [W_feat; W_alpha], joined at h3.
    wfa = torch.cat([layers["fc_feat"][0], layers["fc_alpha"][0]], dim=1)
    dh3 = r(torch.cat([dfeat, dsigma], dim=-1)) @ r(wfa).t()
    dh3 = torch.where(h3 > 0, dh3, torch.zeros_like(dh3))
    dh2 = back(dh3, "layers_xyz.2", h2)
    dh1 = back(dh2, "layers_xyz.1", h1)
    da0 = back(dh1, "layers_xyz.0")                    # layer1 has no ReLU: no mask

    pairs = {
        "layer1": (enc, da0), "layers_xyz.0": (a0, dh1), "layers_xyz.1": (h1, dh2),
        "layers_xyz.2": (h2, dh3), "fc_feat": (h3, dfeat), "fc_alpha": (h3, dsigma),
        "layers_dir.0": (feat, dhd), "fc_rgb": (hd, drgb),
    }
    grads = []
    for name, _, _ in _LAYOUT:
        x, dy = pairs[name]
        grads += [(r(x).t() @ r(dy)).reshape(-1), dy.sum(dim=0)]
    return torch.cat(grads), dhd.reshape(n, s, _DIR_HIDDEN).sum(dim=1)


def _layout() -> TrainLayout:
    return TrainLayout(res_rows=_RES_ROWS, tc_res_rows=_TC_RES_ROWS, delta_rows=_DELTA_ROWS,
                       n_params=_NUM_PARAMS, tile=_TILE, tiles_per_chunk=_TILES_PER_CHUNK,
                       dc_width=_DIR_HIDDEN)


@functools.lru_cache(maxsize=None)
def _kernels():
    from ._build import load_library

    lib = load_library()
    lib.nerf_flex_train_layout.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.nerf_flex_train_layout.restype = None
    layout = (ctypes.c_int * 9)()
    lib.nerf_flex_train_layout(layout)
    want = (_RES_ROWS, _DELTA_ROWS, _NUM_PARAMS, IMAGES.f32_backward.size, _TILE,
            _TILES_PER_CHUNK, _TC_RES_ROWS, IMAGES.tc_forward.size, IMAGES.tc_backward.size)
    if tuple(layout) != want:
        raise RuntimeError(f"csrc/flex_train.cu layout {tuple(layout)} != wrapper's {want}")
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fwd = lib.nerf_flex_train_forward
    fwd.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr, ptr, i32, i64, i32, i32, ptr]
    fwd.restype = ctypes.c_int
    bwd = lib.nerf_flex_train_backward
    bwd.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr, i32, i64, i32, i32, ptr]
    bwd.restype = ctypes.c_int
    return fwd, bwd


_LAUNCHES = TrainLaunches(
    name="fused_flex_mlp_train",
    layout=_layout,
    kernels=_kernels,
    images=lambda: IMAGES,
)


def flex_train_fwd_scenes(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                          compute_dtype: str = "float32"):
    """The forward over S scenes: pts (S, N, P, 3), dc (S, N, 64), params
    (S, 82820) -> ``(raw (S, N, P, 4) f32, residuals)``. One launch of the
    kernel on CUDA tensors; the plain version scene by scene on CPU ones."""
    if pts.device.type == "cpu":
        return plain_forward_scenes(flex_train_plain_fwd, pts, dc, params, compute_dtype)
    return launch_forward(_LAUNCHES, fused_flex_mlp_train, pts, dc, params, compute_dtype)


def flex_train_bwd_scenes(g: torch.Tensor, residuals, params: torch.Tensor,
                          compute_dtype: str = "float32"):
    """The backward over S scenes: g (S, N, P, 4) and ``flex_train_fwd_scenes``'
    residuals -> ``(d params (S, 82820), ddc (S, N, 64))``. One launch of the
    kernels on CUDA tensors; the plain version scene by scene on CPU ones."""
    if g.device.type == "cpu":
        return plain_backward_scenes(flex_train_plain_bwd, g, residuals, params, compute_dtype)
    return launch_backward(_LAUNCHES, fused_flex_mlp_train, g, residuals, params, compute_dtype)


def flex_train_fwd(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                   compute_dtype: str = "float32"):
    """The forward of one scene: the kernel on CUDA tensors (the scene-batched
    wrapper at S = 1, which launches the single-scene kernel), the plain
    version on CPU ones."""
    if pts.device.type == "cpu":
        return flex_train_plain_fwd(pts, dc, params, compute_dtype)
    out, (res,) = flex_train_fwd_scenes(pts[None], dc[None], params[None], compute_dtype)
    return out[0], (res[0],)


def flex_train_bwd(g: torch.Tensor, residuals, params: torch.Tensor, n: int, s: int,
                   compute_dtype: str = "float32"):
    """The backward of one scene: the kernels on CUDA tensors (the
    scene-batched wrapper at S = 1, which launches the single-scene
    kernels), the plain version on CPU ones."""
    if g.device.type == "cpu":
        return flex_train_plain_bwd(g, residuals, params, n, s, compute_dtype)
    if tuple(g.shape) != (n, s, 4):
        raise ValueError(f"fused_flex_mlp_train backward: want a ({n}, {s}, 4) cotangent, got "
                         f"{tuple(g.shape)}")
    (res,) = residuals
    grad, ddc = flex_train_bwd_scenes(g[None], (res[None],), params[None], compute_dtype)
    return grad[0], ddc[0]


_FAMILY = TrainKernelFamily(
    name="fused_flex_mlp_train",
    supports=supports_fused,
    dir_contribution=dir_contribution,
    pack_params=pack_params,
    static_args=lambda model: (),
    forward=flex_train_fwd_scenes,
    backward=flex_train_bwd_scenes,
)

fused_flex_mlp_train = build_train_vjp(_FAMILY)
fused_flex_mlp_train.__doc__ = """Differentiable fused FlexibleNeRF evaluation for training:
``fused_flex_mlp_train(model, pts (N, S, 3), viewdirs (N, 3), compute_dtype)``
-> (N, S, 4) raw [r, g, b, sigma] f32. Forward and backward are the kernels
of ``csrc/flex_train.cu`` on CUDA tensors (the plain version on CPU
tensors). pts and viewdirs get no gradient."""
fused_flex_mlp_train.fwd_launches = 0
fused_flex_mlp_train.bwd_launches = 0

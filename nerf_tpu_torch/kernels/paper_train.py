"""Fused PaperNeRF (8x256) training kernels: forward + backward.

Replaces ``nerf_tpu/ops/pallas/paper_train.py:fused_paper_mlp_train`` (the
custom-VJP pair that ``train_vjp.py:build_train_vjp`` builds; ``pallas_call``
at ``train_vjp.py:197`` forward and ``:241`` backward) with hand-written CUDA
kernels for Hopper in ``csrc/paper_train.cu``, behind one
``torch.autograd.Function`` (``kernels/train_vjp.py``):

- forward: ``paper_t``'s evaluation (N, S, 3) + dc (N, 128) -> (N, S, 4) raw
  f32, saving the residuals in the compute dtype: enc, the eight post-ReLU
  trunk activations, feat (not ReLU'd) and the three post-ReLU direction
  activations;
- backward: (N, S, 4) f32 cotangent + residuals -> the gradient of the
  packed parameter buffer (``kernels/paper_t.pack_params``'s layout: every
  weight and bias but the viewdir columns of ``layers_dir[0]`` and the dead
  ``layers_dir[3]``) and ddc (N, 128), the gradient of the per-ray direction
  contribution. Four launches (layer gradients, weight gradients per chunk
  of points, a fixed-order sum over chunks, ddc per ray): deterministic, no
  atomics.

``compute_dtype="float32"`` runs both on f32 FMAs; ``"bfloat16"`` runs the
forward, the layer gradients and the weight gradients on the tensor cores
(bf16 operands, f32 sums): the forward and the layer gradients on
``mma.sync`` (``csrc/paper_tc.cuh``), with bf16 copies of the weights in the
instruction's fragment order (``kernels/paper_t.images``' ``tc_forward`` and
``tc_backward``) built once per call; the weight gradients on ``wgmma``
(``csrc/wgrad_wg.cuh``: one persistent block an SM, the residual and delta
rows streamed by tensor copies), bitwise the ``mma.sync`` tile it replaced.

``layers_dir[3]`` is never run, so autograd gives it no gradient; the
trainer's ``create_train_state`` sets every gradient to zeros and steps
keep them (``zero_grad(set_to_none=False)``), so it ends each step with a
zero gradient, as the JAX kernel gives it. pts and viewdirs get no gradient.

``paper_train_plain_fwd`` / ``paper_train_plain_bwd`` are the plain PyTorch
version: the same residuals and the same gradients from them, by the
hand-derived backward. CPU tensors take them; CUDA tensors take the kernels
or raise. With ``compute_dtype="bfloat16"`` both operands of every product
are rounded to bf16 and the sums stay f32; bias gradients and ddc sum the
unrounded f32 gradients. (The JAX kernel sums its bias gradients with a
ones-row dot at DEFAULT precision, which rounds dY to bf16 on the TPU and
not on the CPU; the port keeps the f32 sums of its kernel #8.)

``paper_train_fwd_scenes`` / ``paper_train_bwd_scenes`` run S scenes of one shape, each
with its own parameters, in one launch each way (the scene is a grid axis
of every pass, ``csrc/scenes.cuh``): the autograd function's ``vmap`` rule
calls them for the multi-scene step. ``paper_train_fwd`` / ``paper_train_bwd`` are
their S = 1 case, which launches the single-scene kernels.

``fused_paper_mlp_train.fwd_launches`` and ``.bwd_launches`` count the
kernels' launches (one per call each, a scene-batched call included);
``.wgmma_bwd_launches`` the backward launches whose weight gradients ran on
the wgmma body (every bf16 one).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from .common import rounder
from .paper_t import (
    _DIR_WIDTH,
    _WIDTH,
    _pad4,
    _pad16,
    dir_contribution,
    images,
    layout,
    num_params,
    pack_params,
    paper_plain_forward,
    supports_fused_paper,
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

_TILE = 64                 # points per block (csrc/paper_mlp.cuh kTile)
_TILES_PER_CHUNK = 32      # point tiles per weight-gradient block
_DELTA_ROWS = 4 + 3 * _DIR_WIDTH + 9 * _WIDTH     # 2692 f32 gradient rows per point


def res_rows(num_freq: int) -> int:
    """Residual rows of a point: enc, h0..h7, feat, d0..d2."""
    return 3 + 6 * num_freq + 9 * _WIDTH + 3 * _DIR_WIDTH


def tc_res_rows(num_freq: int) -> int:
    """Residual rows of a point in the bf16 kernels, enc padded to 16."""
    return _pad16(3 + 6 * num_freq) + 9 * _WIDTH + 3 * _DIR_WIDTH


def residuals_as_plain(residuals, n_points: int, num_freq: int, compute_dtype: str = "float32"):
    """``paper_train_fwd``'s residuals as views in the plain version's form,
    (enc, h0..h7, feat, d0, d1, d2), each (n_points, C) in the compute dtype:
    the plain backward run on the forward kernel's own residuals is the
    backward kernel's plain version on the same inputs. The kernel's f32
    buffer is res[tile][row][point], its bf16 one res[point][row] with enc
    padded to 16; the plain forward's (CPU) residuals are returned as they
    are."""
    if len(residuals) != 1:
        return tuple(residuals)
    (res,) = residuals
    dim = 3 + 6 * num_freq
    if compute_dtype == "bfloat16":
        rows, kin = tc_res_rows(num_freq), _pad16(dim)
        table = res.view(-1, rows)[:n_points]
    else:
        rows, kin = res_rows(num_freq), dim
        table = res.view(-1, rows, _TILE).transpose(1, 2).reshape(-1, rows)[:n_points]
    widths = [dim] + [_WIDTH] * 9 + [_DIR_WIDTH] * 3
    starts = [0] + [kin + _WIDTH * i for i in range(9)] + [
        kin + 9 * _WIDTH + _DIR_WIDTH * i for i in range(3)]
    return tuple(table[:, a:a + w] for a, w in zip(starts, widths))


def paper_train_plain_fwd(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                          compute_dtype: str = "float32", num_freq: int = 10):
    """Plain version of the forward kernel: ``(raw (N, S, 4) f32, residuals)``,
    residuals = (enc, h0..h7, feat, d0, d1, d2), each (N*S, C) in the compute
    dtype."""
    out, residuals = paper_plain_forward(pts, dc, params, num_freq, compute_dtype)
    store = torch.bfloat16 if compute_dtype == "bfloat16" else torch.float32
    return out, tuple(x.to(store) for x in residuals)


def paper_train_plain_bwd(g: torch.Tensor, residuals, params: torch.Tensor, n: int, s: int,
                          compute_dtype: str = "float32", num_freq: int = 10):
    """Plain version of the backward kernel: ``(d params in the packed layout
    (zero pads), ddc (N, 128))`` from the cotangent and the residuals."""
    r = rounder(compute_dtype)
    layers = unpack_params(params.float(), num_freq)
    dim = 3 + 6 * num_freq
    enc, *hs = (x.float() for x in residuals)
    hs, feat, ds = hs[:8], hs[8], hs[9:]
    g = g.reshape(-1, 4).float()
    drgb, dsigma = g[:, :3], g[:, 3:]

    def back(dy, w, mask=None):
        # dX = dY W^T (W stored (in, out)), masked where the stored post-ReLU
        # activation is not positive.
        dx = r(dy) @ r(w).t()
        return dx if mask is None else torch.where(mask > 0, dx, torch.zeros_like(dx))

    def weight(name):
        return layers[name][0]

    dd2 = back(drgb, weight("fc_rgb"), ds[2])
    dd1 = back(dd2, weight("layers_dir.2"), ds[1])
    dd0 = back(dd1, weight("layers_dir.1"), ds[0])
    # The heads join at feat: [dd0; dsigma] against [W_d0 feat rows; W_alpha].
    dfeat = back(torch.cat([dd0, dsigma], dim=-1),
                 torch.cat([weight("layers_dir.0"), weight("fc_alpha")], dim=1))
    dz = {7: back(dfeat, weight("fc_feat"), hs[7])}
    for i in range(7, 0, -1):
        # The skip layer sends gradient to h3 only; enc is data.
        w = weight(f"layers_xyz.{i}")
        dz[i - 1] = back(dz[i], w[dim:] if i == 4 else w, hs[i - 1])

    pairs = {f"layers_xyz.{i}": (enc if i == 0 else torch.cat([enc, hs[3]], -1) if i == 4
                                 else hs[i - 1], dz[i]) for i in range(8)}
    pairs.update({"fc_feat": (hs[7], dfeat), "fc_alpha": (feat, dsigma),
                  "layers_dir.0": (feat, dd0), "layers_dir.1": (ds[0], dd1),
                  "layers_dir.2": (ds[1], dd2), "fc_rgb": (ds[2], drgb)})
    grads = []
    for name, i, o in layout(num_freq):
        x, dy = pairs[name]
        for part in ((r(x).t() @ r(dy)).reshape(-1), dy.sum(dim=0)):
            grads += [part, part.new_zeros(_pad4(part.numel()) - part.numel())]
    return torch.cat(grads), dd0.reshape(n, s, _DIR_WIDTH).sum(dim=1)


def _layout(num_freq: int) -> TrainLayout:
    return TrainLayout(res_rows=res_rows(num_freq), tc_res_rows=tc_res_rows(num_freq),
                       delta_rows=_DELTA_ROWS, n_params=num_params(num_freq), tile=_TILE,
                       tiles_per_chunk=_TILES_PER_CHUNK, dc_width=_DIR_WIDTH)


@functools.lru_cache(maxsize=None)
def _kernels(num_freq: int):
    from ._build import load_library

    lib = load_library()
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    lib.nerf_paper_train_layout.argtypes = [i32, ctypes.POINTER(ctypes.c_int)]
    lib.nerf_paper_train_layout.restype = None
    got = (ctypes.c_int * 9)()
    lib.nerf_paper_train_layout(num_freq, got)
    im = images(num_freq)
    want = (res_rows(num_freq), _DELTA_ROWS, num_params(num_freq), im.f32_backward.size, _TILE,
            _TILES_PER_CHUNK, tc_res_rows(num_freq), im.tc_forward.size, im.tc_backward.size)
    if tuple(got) != want:
        raise RuntimeError(f"csrc/paper_train.cu layout {tuple(got)} != wrapper's {want}")
    fwd = lib.nerf_paper_train_forward
    fwd.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr, ptr, i32, i64, i32, i32, i32, ptr]
    fwd.restype = ctypes.c_int
    bwd = lib.nerf_paper_train_backward
    bwd.argtypes = [ptr, ptr, ptr, i64, ptr, ptr, ptr, ptr, i32, i64, i32, i32, i32, ptr]
    bwd.restype = ctypes.c_int
    return fwd, bwd


_LAUNCHES = TrainLaunches(
    name="fused_paper_mlp_train",
    layout=_layout,
    kernels=_kernels,
    images=images,
)


def paper_train_fwd_scenes(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                           compute_dtype: str = "float32", num_freq: int = 10):
    """The forward over S scenes: pts (S, N, P, 3), dc (S, N, 128), params
    (S, num_params) -> ``(raw (S, N, P, 4) f32, residuals)``. One launch of
    the kernel on CUDA tensors; the plain version scene by scene on CPU
    ones."""
    if pts.device.type == "cpu":
        return plain_forward_scenes(paper_train_plain_fwd, pts, dc, params, compute_dtype,
                                    num_freq)
    return launch_forward(_LAUNCHES, fused_paper_mlp_train, pts, dc, params, compute_dtype,
                          num_freq)


def paper_train_bwd_scenes(g: torch.Tensor, residuals, params: torch.Tensor,
                           compute_dtype: str = "float32", num_freq: int = 10):
    """The backward over S scenes: g (S, N, P, 4) and
    ``paper_train_fwd_scenes``' residuals -> ``(d params (S, num_params), ddc
    (S, N, 128))``. One launch of the kernels on CUDA tensors; the plain
    version scene by scene on CPU ones."""
    if g.device.type == "cpu":
        return plain_backward_scenes(paper_train_plain_bwd, g, residuals, params, compute_dtype,
                                     num_freq)
    before = fused_paper_mlp_train.bwd_launches
    out = launch_backward(_LAUNCHES, fused_paper_mlp_train, g, residuals, params,
                          compute_dtype, num_freq)
    if compute_dtype == "bfloat16":   # the weight gradients' only bf16 body
        fused_paper_mlp_train.wgmma_bwd_launches += fused_paper_mlp_train.bwd_launches - before
    return out


def paper_train_fwd(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                    compute_dtype: str = "float32", num_freq: int = 10):
    """The forward of one scene: the kernel on CUDA tensors (the scene-batched
    wrapper at S = 1, which launches the single-scene kernel), the plain
    version on CPU ones."""
    if pts.device.type == "cpu":
        return paper_train_plain_fwd(pts, dc, params, compute_dtype, num_freq)
    out, (res,) = paper_train_fwd_scenes(pts[None], dc[None], params[None], compute_dtype,
                                         num_freq)
    return out[0], (res[0],)


def paper_train_bwd(g: torch.Tensor, residuals, params: torch.Tensor, n: int, s: int,
                    compute_dtype: str = "float32", num_freq: int = 10):
    """The backward of one scene: the kernels on CUDA tensors (the
    scene-batched wrapper at S = 1, which launches the single-scene
    kernels), the plain version on CPU ones."""
    if g.device.type == "cpu":
        return paper_train_plain_bwd(g, residuals, params, n, s, compute_dtype, num_freq)
    if tuple(g.shape) != (n, s, 4):
        raise ValueError(f"fused_paper_mlp_train backward: want a ({n}, {s}, 4) cotangent, "
                         f"got {tuple(g.shape)}")
    (res,) = residuals
    grad, ddc = paper_train_bwd_scenes(g[None], (res[None],), params[None], compute_dtype,
                                       num_freq)
    return grad[0], ddc[0]


_FAMILY = TrainKernelFamily(
    name="fused_paper_mlp_train",
    supports=supports_fused_paper,
    dir_contribution=dir_contribution,
    pack_params=pack_params,
    static_args=lambda model: (model.num_encoding_fn_xyz,),
    forward=paper_train_fwd_scenes,
    backward=paper_train_bwd_scenes,
)

fused_paper_mlp_train = build_train_vjp(_FAMILY)
fused_paper_mlp_train.__doc__ = """Differentiable fused PaperNeRF evaluation for training:
``fused_paper_mlp_train(model, pts (N, S, 3), viewdirs (N, 3), compute_dtype)``
-> (N, S, 4) raw [r, g, b, sigma] f32. Forward and backward are the kernels
of ``csrc/paper_train.cu`` on CUDA tensors (the plain version on CPU
tensors). pts and viewdirs get no gradient; ``layers_dir[3]`` none either."""
fused_paper_mlp_train.fwd_launches = 0
fused_paper_mlp_train.bwd_launches = 0
fused_paper_mlp_train.wgmma_bwd_launches = 0

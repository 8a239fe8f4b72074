"""The differentiable training evaluation around a fused kernel pair (port of
``nerf_tpu/ops/pallas/train_vjp.py:build_train_vjp``), and the scene-batched
launches that the two families' pairs share.

A kernel family declares a :class:`TrainKernelFamily`: its shape gate, its
direction split, its packed parameter buffer, and a forward and a backward
over a leading scene axis that each take the kernel on CUDA tensors and the
family's plain PyTorch version, scene by scene, on CPU tensors.
``build_train_vjp`` wraps them in one ``torch.autograd.Function``:

- ``dc = family.dir_contribution(model, viewdirs)``, the per-ray
  ``enc(viewdirs) @ W_dir[:, split:].T`` (N, D) at the family's split row
  and width (FlexibleNeRF: 128 and 64; PaperNeRF: 256 and 128; the JAX
  package's ``wdir_split_row``/``dir_width``), is computed outside the
  kernels with one host matmul, under autograd, so the viewdir columns of
  ``layers_dir[0]`` get their gradient from ``ddc`` through that matmul
  (``train_vjp.py:170-174, 253-255`` of the JAX package);
- the packed parameter buffer is a differentiable ``torch.cat`` of the
  model's parameters, so the backward's gradient of the buffer reaches each
  ``nn.Parameter`` through autograd and nothing assembles gradients by hand;
- ``pts`` and ``viewdirs`` get no gradient (training data), as in JAX.

Scenes: the Function's inputs are ``pts (S, N, P, 3)``, ``dc (S, N, D)``
and ``params (S, n)``, its output ``(S, N, P, 4)``, and the kernels take
the scene as a grid axis (``csrc/scenes.cuh``), so S scenes cost one
forward and one backward launch. A call on one model is its S = 1 case.
Its ``vmap`` rule folds a vmapped dimension into the scene axis: under
``torch.func.vmap`` over stacked parameters (the multi-scene step,
``parallel/multiscene.py``) every scene of the batch goes through one
launch each way, as ``pallas_call``'s batching rule gives the JAX pair a
grid axis of the scene. ``pack_params``' ``torch.cat`` and
``dir_contribution``'s matmul run under the vmap, so the graph reaches the
stacked parameters.

Precision policy (``train_vjp.py:47-55``): float32 means real float32. The
host matmul and its gradient run in full f32 on the bfloat16 path too: each
family's ``dir_contribution`` goes through ``kernels/common.f32_matmul``, which
turns ``torch.backends.cuda.matmul.allow_tf32`` off around that product only
and leaves the caller's setting as it was.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .common import aligned, check_compute_dtype, check_rc, cuda_stream


class TrainKernelFamily(NamedTuple):
    """What is a kernel family's own; ``build_train_vjp`` owns the rest."""

    name: str
    # model -> True when the family's kernels take its shape.
    supports: Callable[..., bool]
    # (model, viewdirs (N, 3)) -> dc (N, D), differentiable in the model.
    dir_contribution: Callable[..., torch.Tensor]
    # model -> the differentiable packed parameter buffer the kernels read.
    pack_params: Callable[..., torch.Tensor]
    # model -> the kernels' trailing arguments that are not tensors (a tuple).
    static_args: Callable[..., tuple]
    # (pts (S, N, P, 3), dc (S, N, D), params (S, n), compute_dtype, *static)
    #   -> (raw (S, N, P, 4) f32, residuals)
    forward: Callable
    # (g (S, N, P, 4), residuals, params (S, n), compute_dtype, *static)
    #   -> (d params (S, n), d dc (S, N, D))
    backward: Callable


def build_train_vjp(family: TrainKernelFamily) -> Callable[..., torch.Tensor]:
    """The family's differentiable evaluation
    ``f(model, pts (N, S, 3), viewdirs (N, 3), compute_dtype) -> (N, S, 4)``
    whose forward and backward are the family's kernels."""

    class _Scenes(torch.autograd.Function):
        # The residuals are the forward's second output, an object that is
        # not a tensor: autograd passes it through, and the backward keeps it
        # as an attribute of its context.
        @staticmethod
        def forward(pts, dc, params, compute_dtype, static):
            return family.forward(pts, dc, params, compute_dtype, *static)

        @staticmethod
        def setup_context(ctx, inputs, output):
            ctx.save_for_backward(inputs[2])
            ctx.residuals = output[1]
            ctx.meta = inputs[3:]

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, g, _):
            (params,) = ctx.saved_tensors
            compute_dtype, static = ctx.meta
            dparams, ddc = family.backward(g, ctx.residuals, params, compute_dtype, *static)
            ctx.residuals = None
            return None, ddc, dparams, None, None

        @staticmethod
        def vmap(info, in_dims, pts, dc, params, compute_dtype, static):
            # Each entry of the vmapped dimension holds scenes: fold it into
            # the scene axis (an unbatched input serves every entry).
            def fold(t, dim):
                t = t.expand(info.batch_size, *t.shape) if dim is None else t.movedim(dim, 0)
                return t.flatten(0, 1)

            out, _ = _Scenes.apply(fold(pts, in_dims[0]), fold(dc, in_dims[1]),
                                   fold(params, in_dims[2]), compute_dtype, static)
            return (out.unflatten(0, (info.batch_size, -1)), None), (0, None)

    def train_fn(model, pts: torch.Tensor, viewdirs: torch.Tensor,
                 compute_dtype: str = "float32") -> torch.Tensor:
        check_compute_dtype(compute_dtype)
        if not family.supports(model):
            raise ValueError(f"{family.name}: the model is not the shape its kernels take")
        dc = family.dir_contribution(model, viewdirs.detach())
        out, _ = _Scenes.apply(pts.detach()[None], dc[None], family.pack_params(model)[None],
                               compute_dtype, family.static_args(model))
        return out[0]

    train_fn.__name__ = family.name
    return train_fn


# --- the scene-batched launches, shared by the families ----------------------


class TrainLayout(NamedTuple):
    """A family's sizes at one set of static arguments: what its wrappers
    allocate for, one scene's worth each."""

    res_rows: int          # f32 residual rows a point
    tc_res_rows: int       # bf16 residual rows a point
    delta_rows: int        # f32 gradient rows a point
    n_params: int          # floats of the packed parameters
    tile: int              # points a tile
    tiles_per_chunk: int   # point tiles a weight-gradient block sums
    dc_width: int          # the per-ray direction contribution's width


class TrainLaunches(NamedTuple):
    """What a family's scene-batched launches read besides the tensors."""

    name: str
    # *static -> TrainLayout
    layout: Callable[..., TrainLayout]
    # *static -> (forward, backward) C entries of the kernel library, whose
    # trailing arguments are (scenes, points a scene, samples a ray, *static,
    # bf16, stream)
    kernels: Callable[..., tuple]
    # *static -> the family's weight images (kernels/common.WeightImage):
    # its .tc_forward, .tc_backward (bf16) and .f32_backward
    images: Callable


def check_cuda(what: str, t: torch.Tensor, *others: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{what}: no kernel for device {t.device}")
    if any(o.device != t.device for o in others):
        raise ValueError(f"{what}: every tensor must be on {t.device}")


def launch_forward(k: TrainLaunches, counter, pts: torch.Tensor, dc: torch.Tensor,
                   params: torch.Tensor, compute_dtype: str, *static):
    """The forward kernel over S scenes, one launch: ``(raw (S, N, P, 4)
    f32, (res,))``, res (S, residuals of a scene) in the compute dtype.
    Adds one to ``counter.fwd_launches``."""
    what = f"{k.name} forward"
    check_cuda(what, pts, dc, params)
    lay = k.layout(*static)
    if pts.ndim != 4 or pts.shape[-1] != 3:
        raise ValueError(f"{what}: want pts (S, N, P, 3), got {tuple(pts.shape)}")
    scenes, n, s = pts.shape[:3]
    if tuple(dc.shape) != (scenes, n, lay.dc_width):
        raise ValueError(f"{what}: want dc ({scenes}, {n}, {lay.dc_width}), got "
                         f"{tuple(dc.shape)}")
    if pts.dtype != torch.float32 or tuple(params.shape) != (scenes, lay.n_params):
        raise ValueError(f"{what}: want float32 pts and ({scenes}, {lay.n_params}) parameters")
    bf16 = check_compute_dtype(compute_dtype)
    tiles = -(-n * s // lay.tile)
    device = pts.device
    out = torch.empty((scenes, n, s, 4), dtype=torch.float32, device=device)
    res = torch.empty((scenes, tiles * (lay.tc_res_rows if bf16 else lay.res_rows) * lay.tile),
                      dtype=torch.bfloat16 if bf16 else torch.float32, device=device)
    if scenes * n * s == 0:
        return out, (res,)
    # The aligned copies are freed when this returns, before the kernel may
    # have run: the caching allocator hands their blocks out again only in
    # this stream's order, after the kernel.
    with torch.cuda.device(device):
        pts_c, dc_c, params_c = (aligned(t) for t in (pts, dc, params))
        wbf = k.images(*static).tc_forward.pack(params_c) if bf16 else None
        check_rc(what, k.kernels(*static)[0](
            pts_c.data_ptr(), dc_c.data_ptr(), params_c.data_ptr(), lay.n_params,
            None if wbf is None else wbf.data_ptr(), 0 if wbf is None else wbf.shape[-1],
            out.data_ptr(), res.data_ptr(), scenes, n * s, s, *static, int(bf16),
            cuda_stream(device)))
    counter.fwd_launches += 1
    return out, (res,)


def launch_backward(k: TrainLaunches, counter, g: torch.Tensor, residuals,
                    params: torch.Tensor, compute_dtype: str, *static):
    """The backward kernels over S scenes, one launch of the pass sequence:
    ``(d params (S, n), ddc (S, N, D))`` from the cotangent (S, N, P, 4) and
    ``launch_forward``'s residuals. Adds one to ``counter.bwd_launches``."""
    what = f"{k.name} backward"
    (res,) = residuals
    check_cuda(what, g, res, params)
    lay = k.layout(*static)
    if g.ndim != 4 or g.shape[-1] != 4:
        raise ValueError(f"{what}: want a cotangent (S, N, P, 4), got {tuple(g.shape)}")
    scenes, n, s = g.shape[:3]
    bf16 = check_compute_dtype(compute_dtype)
    tiles = -(-n * s // lay.tile)
    chunks = -(-tiles // lay.tiles_per_chunk)
    rows = lay.tc_res_rows if bf16 else lay.res_rows
    if (tuple(res.shape) != (scenes, tiles * rows * lay.tile) or not res.is_contiguous()
            or res.dtype != (torch.bfloat16 if bf16 else torch.float32)):
        raise ValueError(f"{what}: residuals {tuple(res.shape)} {res.dtype} are not a "
                         f"{compute_dtype} forward's at ({scenes}, {n}, {s})")
    if tuple(params.shape) != (scenes, lay.n_params):
        raise ValueError(f"{what}: want ({scenes}, {lay.n_params}) parameters")
    device = g.device
    grad = torch.empty((scenes, lay.n_params), dtype=torch.float32, device=device)
    ddc = torch.empty((scenes, n, lay.dc_width), dtype=torch.float32, device=device)
    if scenes * n * s == 0:
        return grad.zero_(), ddc
    # Scratch, freed when this returns: the caching allocator hands the
    # blocks out again only in this stream's order, after the kernels.
    delta = torch.empty((scenes, tiles * lay.delta_rows * lay.tile), dtype=torch.float32,
                        device=device)
    partial = torch.empty((scenes, chunks * lay.n_params), dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        g_c = aligned(g)
        images = k.images(*static)
        wt = (images.tc_backward.pack(params) if bf16
              else aligned(images.f32_backward.pack(params.detach())))
        check_rc(what, k.kernels(*static)[1](
            g_c.data_ptr(), res.data_ptr(), wt.data_ptr(), wt.shape[-1], delta.data_ptr(),
            partial.data_ptr(), grad.data_ptr(), ddc.data_ptr(), scenes, n * s, s, *static,
            int(bf16), cuda_stream(device)))
    counter.bwd_launches += 1
    return grad, ddc


def plain_forward_scenes(plain_fwd: Callable, pts: torch.Tensor, dc: torch.Tensor,
                         params: torch.Tensor, compute_dtype: str, *static):
    """The plain forward scene by scene (CPU tensors): ``(raw (S, N, P, 4),
    [each scene's residuals])``."""
    outs, residuals = zip(*(plain_fwd(pts[i], dc[i], params[i], compute_dtype, *static)
                            for i in range(pts.shape[0])))
    return torch.stack(outs), list(residuals)


def plain_backward_scenes(plain_bwd: Callable, g: torch.Tensor, residuals,
                          params: torch.Tensor, compute_dtype: str, *static):
    """The plain backward scene by scene on ``plain_forward_scenes``'
    residuals: ``(d params (S, n), ddc (S, N, D))``."""
    n, s = g.shape[1], g.shape[2]
    grads, ddcs = zip(*(plain_bwd(g[i], residuals[i], params[i], n, s, compute_dtype, *static)
                        for i in range(g.shape[0])))
    return torch.stack(grads), torch.stack(ddcs)

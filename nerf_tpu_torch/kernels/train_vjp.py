"""The differentiable training evaluation around a fused kernel pair (port of
``nerf_tpu/ops/pallas/train_vjp.py:build_train_vjp``).

A kernel family declares a :class:`TrainKernelFamily`: its shape gate, its
direction split, its packed parameter buffer, and a forward and a backward
that each take the kernel on CUDA tensors and the family's plain PyTorch
version on CPU tensors. ``build_train_vjp`` wraps them in one
``torch.autograd.Function``:

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

Precision policy (``train_vjp.py:47-55``): float32 means real float32. The
host matmul and its gradient run in full f32 on the bfloat16 path too: each
family's ``dir_contribution`` goes through ``kernels/mlp.f32_matmul``, which
turns ``torch.backends.cuda.matmul.allow_tf32`` off around that product only
and leaves the caller's setting as it was.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

_COMPUTE_DTYPES = ("float32", "bfloat16")


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
    # (pts (N, S, 3), dc (N, D), params, compute_dtype, *static)
    #   -> (raw (N, S, 4) f32, residuals)
    forward: Callable
    # (g (N, S, 4), residuals, params, n, s, compute_dtype, *static)
    #   -> (d params, d dc (N, D))
    backward: Callable


def build_train_vjp(family: TrainKernelFamily) -> Callable[..., torch.Tensor]:
    """The family's differentiable evaluation
    ``f(model, pts (N, S, 3), viewdirs (N, 3), compute_dtype) -> (N, S, 4)``
    whose forward and backward are the family's kernels."""

    class _Fn(torch.autograd.Function):
        @staticmethod
        def forward(ctx, pts, dc, params, compute_dtype, static):
            out, residuals = family.forward(pts, dc, params, compute_dtype, *static)
            ctx.save_for_backward(params)
            ctx.residuals = residuals
            ctx.meta = (pts.shape[0], pts.shape[1], compute_dtype, static)
            return out

        @staticmethod
        @torch.autograd.function.once_differentiable
        def backward(ctx, g):
            (params,) = ctx.saved_tensors
            n, s, compute_dtype, static = ctx.meta
            dparams, ddc = family.backward(g, ctx.residuals, params, n, s, compute_dtype, *static)
            ctx.residuals = None
            return None, ddc, dparams, None, None

    def train_fn(model, pts: torch.Tensor, viewdirs: torch.Tensor,
                 compute_dtype: str = "float32") -> torch.Tensor:
        if compute_dtype not in _COMPUTE_DTYPES:
            raise ValueError(f"compute_dtype must be one of {_COMPUTE_DTYPES}")
        if not family.supports(model):
            raise ValueError(f"{family.name}: the model is not the shape its kernels take")
        dc = family.dir_contribution(model, viewdirs.detach())
        return _Fn.apply(pts.detach(), dc, family.pack_params(model), compute_dtype,
                         family.static_args(model))

    train_fn.__name__ = family.name
    return train_fn

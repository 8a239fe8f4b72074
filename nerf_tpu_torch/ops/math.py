"""Elementwise math primitives (port of ``nerf_tpu/ops/math.py``)."""

from __future__ import annotations

import torch


def img2mse(img_src: torch.Tensor, img_tgt: torch.Tensor) -> torch.Tensor:
    """Mean squared error between a synthesized and a target image (or ray batch)."""
    diff = img_src - img_tgt
    return torch.mean(diff * diff)


def mse2psnr(mse) -> torch.Tensor:
    """PSNR (dB) from an MSE; an MSE <= 0 is clamped to 1e-5 as the reference does."""
    mse = torch.as_tensor(mse)
    mse = torch.where(mse <= 0.0, torch.full_like(mse, 1e-5), mse)
    return -10.0 * torch.log10(mse)


def cumprod_exclusive(x: torch.Tensor) -> torch.Tensor:
    """Exclusive cumulative product along the last axis: out[..., 0] = 1,
    out[..., i] = prod(x[..., :i])."""
    ones = torch.ones_like(x[..., :1])
    return torch.cumprod(torch.cat([ones, x[..., :-1]], dim=-1), dim=-1)

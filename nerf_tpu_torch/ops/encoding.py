"""Sinusoidal positional encoding (port of ``nerf_tpu/ops/encoding.py``).

Feature layout is the reference's, which checkpoints depend on:
``[x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]``, each sin/cos block
spanning the whole channel axis.
"""

from __future__ import annotations

import math

import torch


def encoding_dim(num_channels: int, num_encoding_functions: int, include_input: bool = True) -> int:
    """Output feature dimension of ``positional_encoding``."""
    base = num_channels if include_input else 0
    if num_encoding_functions == 0 and not include_input:
        # positional_encoding passes the input through in this case.
        return num_channels
    return base + 2 * num_channels * num_encoding_functions


def frequency_bands(
    num_encoding_functions: int,
    log_sampling: bool = True,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Frequency multipliers 2^linspace(0, N-1, N) (log) or linspace(1, 2^(N-1), N)."""
    top = max(num_encoding_functions - 1, 0)
    steps = max(num_encoding_functions, 1)
    if log_sampling:
        return 2.0 ** torch.linspace(0.0, top, steps, dtype=dtype, device=device)
    return torch.linspace(1.0, 2.0 ** top, steps, dtype=dtype, device=device)


def positional_encoding(
    tensor: torch.Tensor,
    num_encoding_functions: int = 6,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Sin/cos encoding of ``tensor`` along its last axis. With
    ``num_encoding_functions == 0`` the input is returned unchanged."""
    if num_encoding_functions == 0:
        return tensor
    freqs = frequency_bands(num_encoding_functions, log_sampling, tensor.dtype, tensor.device)
    scaled = tensor[..., None, :] * freqs[:, None]                       # (..., F, C)
    interleaved = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)  # (..., F, 2, C)
    flat = interleaved.reshape(
        *tensor.shape[:-1], 2 * num_encoding_functions * tensor.shape[-1]
    )
    if include_input:
        return torch.cat([tensor, flat], dim=-1)
    return flat


def coarse_to_fine_window(
    num_encoding_functions: int, alpha: float, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """BARF per-frequency window (eq. 14): band k is 0 while alpha < k, 1 once
    alpha >= k + 1, and a cosine ramp in between."""
    k = torch.arange(num_encoding_functions, dtype=dtype, device=device)
    x = torch.clamp(alpha - k, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * x))

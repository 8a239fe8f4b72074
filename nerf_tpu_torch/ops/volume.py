"""Volume rendering (alpha compositing) of a radiance field (port of
``nerf_tpu/ops/volume.py``).

Semantics kept: inter-sample distances with a 1e10 far sentinel (or a given
``final_dists``) scaled by ||ray_dir||; rgb = sigmoid(raw); optional
Gaussian noise on raw sigma before the relu; weights = alpha *
exclusive-cumprod(1 - alpha + 1e-10); a guarded disparity; white background.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .math import cumprod_exclusive


class RenderOutputs(NamedTuple):
    """Per-ray composited maps."""

    rgb: torch.Tensor        # (..., 3)
    disp: torch.Tensor       # (...,)
    acc: torch.Tensor        # (...,)
    weights: torch.Tensor    # (..., num_samples)
    depth: torch.Tensor      # (...,)


def volume_render_radiance_field(
    radiance_field: torch.Tensor,
    depth_values: torch.Tensor,
    ray_directions: torch.Tensor,
    radiance_field_noise_std: float = 0.0,
    white_background: bool = False,
    generator: Optional[torch.Generator] = None,
    final_dists: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> RenderOutputs:
    """Composite raw (..., S, 4) [r, g, b, sigma] at depths (..., S) along
    (..., 3) un-normalized directions into rgb/disp/acc/weights/depth.

    ``final_dists`` (...,) replaces the 1e10 thickness of the last sample;
    ``noise`` (..., S) standard normals replace the generator's draw.
    """
    if final_dists is None:
        last = torch.full_like(depth_values[..., :1], 1e10)
    else:
        last = final_dists[..., None].to(depth_values.dtype)
    dists = torch.cat([depth_values[..., 1:] - depth_values[..., :-1], last], dim=-1)
    dists = dists * torch.linalg.norm(ray_directions, dim=-1)[..., None]

    rgb = torch.sigmoid(radiance_field[..., :3])
    sigma_raw = radiance_field[..., 3]
    if radiance_field_noise_std > 0.0:
        if noise is None:
            noise = torch.randn(sigma_raw.shape, generator=generator, dtype=sigma_raw.dtype,
                                device=sigma_raw.device)
        sigma_raw = sigma_raw + noise * radiance_field_noise_std
    sigma = torch.relu(sigma_raw)

    alpha = 1.0 - torch.exp(-sigma * dists)
    weights = alpha * cumprod_exclusive(1.0 - alpha + 1e-10)

    rgb_map = torch.sum(weights[..., None] * rgb, dim=-2)
    depth_map = torch.sum(weights * depth_values, dim=-1)
    acc_map = torch.sum(weights, dim=-1)
    # Guarded: an empty ray (acc == 0) gets a finite 1e10 disparity, not NaN.
    disp_map = 1.0 / torch.clamp(depth_map / torch.clamp(acc_map, min=1e-10), min=1e-10)

    if white_background:
        rgb_map = rgb_map + (1.0 - acc_map[..., None])
    return RenderOutputs(rgb_map, disp_map, acc_map, weights, depth_map)

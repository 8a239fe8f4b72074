"""Procedural synthetic scene: an analytic radiance field rendered to images
(port of ``nerf_tpu/data/synthetic.py``).

A soft emissive sphere with a position-dependent colour, rendered by the same
volume renderer the models train against: a dataset that needs no download,
and a field a NeRF MLP fits to high PSNR in a few hundred steps. Rendering
runs on the device given; the results are numpy, as in the JAX package.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.rays import get_ray_bundle
from ..ops.sampling import coarse_z_values
from ..ops.volume import volume_render_radiance_field
from .poses import pose_spherical


def analytic_radiance_field(pts: torch.Tensor, phase: float = 0.0,
                            sphere_radius: float = 0.8) -> torch.Tensor:
    """Raw radiance field [r, g, b, sigma] at world points (pre-sigmoid /
    pre-relu): a soft sphere at the origin, smooth colour."""
    r = torch.linalg.norm(pts, dim=-1)
    sigma = 40.0 * (sphere_radius - r)
    rgb = torch.stack(
        [
            2.0 * torch.sin(3.0 * pts[..., 0] + phase),
            2.0 * torch.cos(3.0 * pts[..., 1] + phase),
            2.0 * torch.sin(3.0 * pts[..., 2] + 1.0 + phase),
        ],
        dim=-1,
    )
    return torch.cat([rgb, sigma[..., None]], dim=-1)


@torch.no_grad()
def render_analytic_image(
    height: int,
    width: int,
    focal: float,
    pose: np.ndarray,
    num_samples: int = 128,
    near: float = 2.0,
    far: float = 6.0,
    white_background: bool = True,
    phase: float = 0.0,
    sphere_radius: float = 0.8,
    device="cpu",
) -> np.ndarray:
    """Ground-truth (H, W, 3) render of the analytic field for one pose."""
    pose = torch.as_tensor(np.asarray(pose), dtype=torch.float32, device=device)
    ro, rd = get_ray_bundle(height, width, focal, pose)
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    z = coarse_z_values(torch.full(ro.shape[:1], near, device=device),
                        torch.full(ro.shape[:1], far, device=device), num_samples)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    rf = analytic_radiance_field(pts, phase=phase, sphere_radius=sphere_radius)
    out = volume_render_radiance_field(rf, z, rd, white_background=white_background)
    return out.rgb.reshape(height, width, 3).cpu().numpy()


class SyntheticDataset(NamedTuple):
    images: np.ndarray       # (N, H, W, 3) float32 in [0, 1]
    poses: np.ndarray        # (N, 4, 4) float32
    hwf: tuple               # (H, W, focal)
    near: float
    far: float


def make_synthetic_dataset(
    num_views: int = 10,
    height: int = 32,
    width: int = 32,
    camera_angle_x: float = 0.6911112070083618,
    radius: float = 4.0,
    num_samples: int = 128,
    white_background: bool = True,
    phase: float = 0.0,
    sphere_radius: float = 0.8,
    seed: int = 1234,
    device="cpu",
) -> SyntheticDataset:
    """Multi-view dataset of the analytic scene: thetas evenly spaced, phis
    drawn by numpy from ``seed`` (the JAX package's poses, pose for pose)."""
    focal = 0.5 * width / np.tan(0.5 * camera_angle_x)
    rng = np.random.default_rng(seed)
    thetas = np.linspace(-180.0, 180.0, num_views, endpoint=False)
    phis = rng.uniform(-45.0, -15.0, num_views)
    poses = np.stack([pose_spherical(t, p, radius) for t, p in zip(thetas, phis)])
    images = np.stack([
        render_analytic_image(height, width, focal, p, num_samples,
                              white_background=white_background, phase=phase,
                              sphere_radius=sphere_radius, device=device)
        for p in poses
    ])
    return SyntheticDataset(images.astype(np.float32), poses.astype(np.float32),
                            (height, width, focal), 2.0, 6.0)


def flatten_rays(dataset: SyntheticDataset, device="cpu"):
    """Every view's rays as one flat store: (ray_origins, ray_directions,
    rgb_targets), each (N*H*W, 3) float32 numpy."""
    from .rays_store import build_ray_store

    h, w, focal = dataset.hwf
    return build_ray_store(dataset.images, dataset.poses, h, w, focal, device=device)

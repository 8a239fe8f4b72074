"""The training data both sides read: a store of rays and colours of an
analytic scene, rendered on the device in a few batched calls.

The scene is a soft emissive sphere of radius 0.8 at the origin with a
smooth colour (the system's procedural synthetic scene, written out again
here so that the inputs are the benchmark's own), seen from ``views``
cameras on a sphere of radius 4 looking at the origin, as the blender
scenes are: thetas evenly spaced, phis drawn from a fixed seed in [-45,
-15] degrees, the lego camera's field of view. Every seed of a run gets the
same store.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

BLENDER_FOV = 0.6911112070083618


def pose_spherical(theta_deg: float, phi_deg: float, radius: float) -> np.ndarray:
    """(4, 4) camera-to-world of a camera at ``radius`` looking at the origin
    (the blender loaders' orbit convention)."""
    th, ph = math.radians(theta_deg), math.radians(phi_deg)
    trans = np.eye(4)
    trans[2, 3] = radius
    rot_phi = np.array([[1, 0, 0, 0], [0, math.cos(ph), -math.sin(ph), 0],
                        [0, math.sin(ph), math.cos(ph), 0], [0, 0, 0, 1]])
    rot_theta = np.array([[math.cos(th), 0, -math.sin(th), 0], [0, 1, 0, 0],
                          [math.sin(th), 0, math.cos(th), 0], [0, 0, 0, 1]])
    flip = np.array([[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]])
    return (flip @ rot_theta @ rot_phi @ trans).astype(np.float32)


def focal_length(width: int) -> float:
    return 0.5 * width / math.tan(0.5 * BLENDER_FOV)


def view_poses(views: int, pose_seed: int) -> np.ndarray:
    rng = np.random.default_rng(pose_seed)
    thetas = np.linspace(-180.0, 180.0, views, endpoint=False)
    phis = rng.uniform(-45.0, -15.0, views)
    return np.stack([pose_spherical(t, p, 4.0) for t, p in zip(thetas, phis)])


def analytic_field(pts: torch.Tensor) -> torch.Tensor:
    """Raw [r, g, b, sigma] of the scene at world points (..., 3)."""
    sigma = 40.0 * (0.8 - torch.linalg.norm(pts, dim=-1))
    rgb = torch.stack([2.0 * torch.sin(3.0 * pts[..., 0]), 2.0 * torch.cos(3.0 * pts[..., 1]),
                       2.0 * torch.sin(3.0 * pts[..., 2] + 1.0)], dim=-1)
    return torch.cat([rgb, sigma[..., None]], dim=-1)


@torch.no_grad()
def render_views(poses: torch.Tensor, height: int, width: int, samples: int = 128,
                 near: float = 2.0, far: float = 6.0):
    """Rays and white-background colours of the views ``poses`` (V, 4, 4),
    all in one pass: (V*H*W, 3) origins, directions and colours."""
    dev = poses.device
    f = focal_length(width)
    j, i = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                          torch.arange(width, device=dev, dtype=torch.float32), indexing="ij")
    dirs = torch.stack([(i - width * 0.5) / f, -(j - height * 0.5) / f,
                        -torch.ones_like(i)], dim=-1).reshape(1, -1, 1, 3)
    rd = torch.sum(dirs * poses[:, None, :3, :3], dim=-1).reshape(-1, 3)
    ro = poses[:, None, :3, 3].expand(-1, height * width, 3).reshape(-1, 3)
    z = torch.linspace(near, far, samples, device=dev)
    raw = analytic_field(ro[:, None, :] + rd[:, None, :] * z[:, None])
    dists = torch.cat([z[1:] - z[:-1], torch.full((1,), 1e10, device=dev)])
    dists = dists * torch.linalg.norm(rd, dim=-1, keepdim=True)
    alpha = 1.0 - torch.exp(-torch.relu(raw[..., 3]) * dists)
    keep = 1.0 - alpha + 1e-10
    w = alpha * torch.cumprod(torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], -1), -1)
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), dim=-2) + (1.0 - w.sum(-1))[:, None]
    return ro.contiguous(), rd, rgb


def make_store(views: int, height: int, width: int, pose_seed: int, device,
               views_per_call: int = 5) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The store of ``views`` views: three (views*H*W, 3) float32 tensors on
    ``device``, rendered ``views_per_call`` views at a time."""
    poses = torch.as_tensor(view_poses(views, pose_seed), device=device)
    n = height * width
    store = [torch.empty((views * n, 3), device=device) for _ in range(3)]
    for v in range(0, views, views_per_call):
        parts = render_views(poses[v:v + views_per_call], height, width)
        for dst, src in zip(store, parts):
            dst[v * n:v * n + src.shape[0]] = src
    return tuple(store)

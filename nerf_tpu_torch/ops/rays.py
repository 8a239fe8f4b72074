"""Ray generation and reparameterization (port of ``nerf_tpu/ops/rays.py``)."""

from __future__ import annotations

import torch


def meshgrid_xy(tensor1: torch.Tensor, tensor2: torch.Tensor):
    """np.meshgrid(..., indexing="xy") semantics."""
    return torch.meshgrid(tensor1, tensor2, indexing="xy")


def get_ray_bundle(height: int, width: int, focal_length, tform_cam2world: torch.Tensor):
    """One ray per pixel of an ``height x width`` image for pose ``tform_cam2world``.

    Pixel (row j, col i) looks along ((i - W/2)/f, -(j - H/2)/f, -1) in the
    camera frame, rotated into the world frame. Returns (H, W, 3) origins and
    (H, W, 3) un-normalized directions on the pose's device.
    """
    index = torch.arange(height * width, device=tform_cam2world.device)
    ray_origins, ray_directions = pixel_rays(height, width, focal_length, tform_cam2world, index)
    return ray_origins.reshape(height, width, 3), ray_directions.reshape(height, width, 3)


def pixel_rays(height: int, width: int, focal_length, tform_cam2world: torch.Tensor,
               index: torch.Tensor):
    """The rays of the flat pixel indices ``index`` (row-major, ``j * W +
    i``) of ``get_ray_bundle``'s image: (len, 3) origins and directions.
    A data-parallel rank makes the rays of its own pixel range with it."""
    dtype = tform_cam2world.dtype
    ii = (index % width).to(dtype)
    jj = (index // width).to(dtype)
    directions = torch.stack(
        [
            (ii - width * 0.5) / focal_length,
            -(jj - height * 0.5) / focal_length,
            -torch.ones_like(ii),
        ],
        dim=-1,
    )
    ray_directions = torch.sum(directions[..., None, :] * tform_cam2world[:3, :3], dim=-1)
    ray_origins = tform_cam2world[:3, -1].expand(ray_directions.shape)
    return ray_origins, ray_directions


def ndc_rays(height, width, focal_length, near, rays_o: torch.Tensor, rays_d: torch.Tensor):
    """Shift ray origins to the near plane and project into NDC space
    (LLFF forward-facing scenes)."""
    t = -(near + rays_o[..., 2]) / rays_d[..., 2]
    rays_o = rays_o + t[..., None] * rays_d

    o0 = -1.0 / (width / (2.0 * focal_length)) * rays_o[..., 0] / rays_o[..., 2]
    o1 = -1.0 / (height / (2.0 * focal_length)) * rays_o[..., 1] / rays_o[..., 2]
    o2 = 1.0 + 2.0 * near / rays_o[..., 2]

    d0 = (
        -1.0
        / (width / (2.0 * focal_length))
        * (rays_d[..., 0] / rays_d[..., 2] - rays_o[..., 0] / rays_o[..., 2])
    )
    d1 = (
        -1.0
        / (height / (2.0 * focal_length))
        * (rays_d[..., 1] / rays_d[..., 2] - rays_o[..., 1] / rays_o[..., 2])
    )
    d2 = -2.0 * near / rays_o[..., 2]

    return torch.stack([o0, o1, o2], dim=-1), torch.stack([d0, d1, d2], dim=-1)


def ray_aabb_interval(rays_o: torch.Tensor, rays_d: torch.Tensor, aabb_min, aabb_max,
                      near: float, far: float):
    """Per-ray (t_near, t_far) tightened to an axis-aligned box (slab method).

    Rays that miss the box keep the untightened [near, far].
    """
    aabb_min = torch.as_tensor(aabb_min, dtype=rays_o.dtype, device=rays_o.device)
    aabb_max = torch.as_tensor(aabb_max, dtype=rays_o.dtype, device=rays_o.device)
    # A huge finite slope for |d| ~ 0: the true reciprocal's inf would make
    # 0 * inf = NaN at the box boundary.
    safe_d = torch.where(rays_d == 0, torch.ones_like(rays_d), rays_d)
    inv_d = torch.where(rays_d.abs() > 1e-9, 1.0 / safe_d, torch.full_like(rays_d, 1e12))
    t1 = (aabb_min - rays_o) * inv_d
    t2 = (aabb_max - rays_o) * inv_d
    t_enter = torch.amax(torch.minimum(t1, t2), dim=-1)
    t_exit = torch.amin(torch.maximum(t1, t2), dim=-1)
    parallel_miss = torch.any(
        (rays_d.abs() <= 1e-9) & ((rays_o < aabb_min) | (rays_o > aabb_max)), dim=-1
    )
    hit = (t_exit >= t_enter) & (t_exit > 0.0) & ~parallel_miss
    t_near = torch.clamp(t_enter, near, far)
    t_far = torch.clamp(t_exit, near, far)
    # A nonempty, ordered interval even for tangent hits.
    t_far = torch.maximum(t_far, t_near + 1e-6)
    return (
        torch.where(hit, t_near, torch.full_like(t_near, near)),
        torch.where(hit, t_far, torch.full_like(t_far, far)),
    )

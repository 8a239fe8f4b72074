"""Camera pose construction helpers (host-side numpy — tiny, run once).
Port of ``nerf_tpu/data/poses.py``, unchanged.

Behavioral parity targets (reference: krrish94/nerf-pytorch):
  - ``translate_by_t_along_z`` / ``rotate_by_phi_along_x`` /
    ``rotate_by_theta_along_y`` / ``pose_spherical`` -> nerf/load_blender.py:10-37
  - ``viewmatrix`` / ``poses_avg`` / ``render_path_spiral`` ->
    nerf/load_llff.py:143-183 (used by the LLFF loader)

Provenance note: the three LLFF pose functions reproduce the reference's
algorithm essentially verbatim (itself vendored from yenchenlin/Fyusion
LLFF code) — a fixed numerical recipe that pose parity depends on
bit-for-bit; renaming variables would not make it a new algorithm.
"""

from __future__ import annotations

import numpy as np


def translate_by_t_along_z(t: float) -> np.ndarray:
    tform = np.eye(4, dtype=np.float32)
    tform[2][3] = t
    return tform


def rotate_by_phi_along_x(phi: float) -> np.ndarray:
    tform = np.eye(4, dtype=np.float32)
    tform[1, 1] = tform[2, 2] = np.cos(phi)
    tform[1, 2] = -np.sin(phi)
    tform[2, 1] = -tform[1, 2]
    return tform


def rotate_by_theta_along_y(theta: float) -> np.ndarray:
    tform = np.eye(4, dtype=np.float32)
    tform[0, 0] = tform[2, 2] = np.cos(theta)
    tform[0, 2] = -np.sin(theta)
    tform[2, 0] = -tform[0, 2]
    return tform


def pose_spherical(theta: float, phi: float, radius: float) -> np.ndarray:
    """Camera-to-world pose on a sphere looking at the origin (degrees).

    Reference nerf/load_blender.py:32-37 — used for the 40-view blender
    render path and our synthetic scenes.
    """
    c2w = translate_by_t_along_z(radius)
    c2w = rotate_by_phi_along_x(phi / 180.0 * np.pi) @ c2w
    c2w = rotate_by_theta_along_y(theta / 180.0 * np.pi) @ c2w
    c2w = (
        np.array(
            [[-1, 0, 0, 0], [0, 0, 1, 0], [0, 1, 0, 0], [0, 0, 0, 1]],
            dtype=np.float32,
        )
        @ c2w
    )
    return c2w


def spherical_render_poses(
    num_poses: int = 40, phi: float = -30.0, radius: float = 4.0
) -> np.ndarray:
    """The blender loader's 360° orbit render path (load_blender.py:78-84)."""
    thetas = np.linspace(-180.0, 180.0, num_poses + 1)[:-1]
    return np.stack([pose_spherical(t, phi, radius) for t in thetas])


# ---------------------------------------------------------------------------
# LLFF-style pose averaging / spiral path (nerf/load_llff.py:143-183)
# ---------------------------------------------------------------------------

def normalize(v: np.ndarray) -> np.ndarray:
    return v / np.linalg.norm(v)


def viewmatrix(z: np.ndarray, up: np.ndarray, pos: np.ndarray) -> np.ndarray:
    """3x4 camera matrix from forward axis, up hint, and position (load_llff.py:143-149)."""
    vec2 = normalize(z)
    vec1_avg = up
    vec0 = normalize(np.cross(vec1_avg, vec2))
    vec1 = normalize(np.cross(vec2, vec0))
    return np.stack([vec0, vec1, vec2, pos], axis=1)


def poses_avg(poses: np.ndarray) -> np.ndarray:
    """Average pose of an (N, 3, 5) LLFF pose array (load_llff.py:157-166)."""
    hwf = poses[0, :3, -1:]
    center = poses[:, :3, 3].mean(0)
    vec2 = normalize(poses[:, :3, 2].sum(0))
    up = poses[:, :3, 1].sum(0)
    return np.concatenate([viewmatrix(vec2, up, center), hwf], axis=1)


def render_path_spiral(
    c2w: np.ndarray,
    up: np.ndarray,
    rads: np.ndarray,
    focal: float,
    zrate: float,
    rots: int,
    N: int,
) -> list:
    """Spiral of render poses around an average pose (load_llff.py:169-183)."""
    render_poses = []
    rads = np.array(list(rads) + [1.0])
    hwf = c2w[:, 4:5]
    for theta in np.linspace(0.0, 2.0 * np.pi * rots, N + 1)[:-1]:
        c = np.dot(
            c2w[:3, :4],
            np.array([np.cos(theta), -np.sin(theta), -np.sin(theta * zrate), 1.0])
            * rads,
        )
        z = normalize(c - np.dot(c2w[:3, :4], np.array([0, 0, -focal, 1.0])))
        render_poses.append(np.concatenate([viewmatrix(z, up, c), hwf], 1))
    return render_poses

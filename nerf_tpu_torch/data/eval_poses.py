"""Resolve the camera poses a checkpoint is rendered from (port of
``nerf_tpu/data/eval_poses.py``).

The dataset type picks the loader, ``render`` means the dataset's orbit
(blender) or spiral (LLFF) trajectory, and ``train``/``val``/``test`` that
split's camera poses: blender's ``transforms_{split}.json`` views, LLFF's
``llffhold`` split. A blender scene without a dataset on disk renders the
standard 40-pose orbit at the config's intrinsics (or 400 px); the procedural
synthetic scene renders the same orbit.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Tuple

import numpy as np

from .blender import composite_white_background, load_blender_data
from .llff import llff_holdout_split, load_llff_data
from .poses import spherical_render_poses

_BLENDER_FOV = 0.6911112070083618


class RenderSplit(NamedTuple):
    poses: np.ndarray                 # (N, 3, 4) float32 camera-to-world
    height: int
    width: int
    focal: float
    images: Optional[np.ndarray]      # (N, H, W, 3) float32 ground truth of a dataset split


def load_render_split(cfg, split: str = "render", white_background: bool = False) -> RenderSplit:
    """The poses and intrinsics of ``split``, and for a dataset split its
    ground-truth images (RGBA composited onto white when
    ``white_background``, else RGB), from one load of the dataset."""
    ds = cfg.dataset
    images = None
    if ds.type == "blender":
        if ds.basedir and os.path.isdir(ds.basedir):
            imgs, all_poses, render_poses, hwf, i_split = load_blender_data(
                ds.basedir, half_res=ds.half_res, testskip=ds.testskip)
            if split != "render":
                sel = i_split[{"train": 0, "val": 1, "test": 2}[split]]
                render_poses = all_poses[sel]
                images = imgs[sel]
                images = (composite_white_background(images) if white_background
                          else images[..., :3])
            h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        else:
            if split != "render":
                # A split without a dataset would silently become the orbit.
                raise ValueError(
                    f"--split {split} needs an on-disk dataset, but "
                    f"dataset.basedir={ds.basedir!r} is not a directory")
            h = int(getattr(ds, "height", 400))
            w = int(getattr(ds, "width", 400))
            focal = float(getattr(ds, "focal", 0.5 * w / np.tan(0.5 * _BLENDER_FOV)))
            render_poses = spherical_render_poses(40, phi=-30.0, radius=4.0)
    elif ds.type == "llff":
        imgs, poses, _, render_poses, i_holdout = load_llff_data(
            ds.basedir, factor=getattr(ds, "downsample_factor", 8),
            spherify=bool(getattr(ds, "spherify", False)),
            path_zflat=bool(getattr(ds, "path_zflat", False)))
        hwf = poses[0, :3, -1]
        h, w, focal = int(hwf[0]), int(hwf[1]), float(hwf[2])
        if split != "render":
            i_train, i_test = llff_holdout_split(poses.shape[0], int(getattr(ds, "llffhold", 8)),
                                                 i_holdout)
            sel = i_train if split == "train" else i_test
            render_poses = poses[sel, :3, :4]
            images = imgs[sel]
    elif ds.type == "synthetic":
        if split != "render":
            raise ValueError(
                "--split train/val/test is not defined for the procedural "
                "synthetic dataset (it has no on-disk splits); use the "
                "default --split render")
        h = w = int(getattr(ds, "image_size", 64))
        focal = 0.5 * w / np.tan(0.5 * _BLENDER_FOV)
        render_poses = spherical_render_poses(40, phi=-30.0, radius=4.0)
    else:
        raise ValueError(f"Unsupported dataset type {ds.type!r} for eval")
    return RenderSplit(np.asarray(render_poses, np.float32)[:, :3, :4], h, w, focal, images)


def resolve_render_poses(cfg, split: str = "render") -> Tuple[np.ndarray, int, int, float]:
    """Return ``(poses (N, 3, 4) float32, height, width, focal)`` of ``split``
    (``load_render_split`` without the images)."""
    return tuple(load_render_split(cfg, split)[:4])

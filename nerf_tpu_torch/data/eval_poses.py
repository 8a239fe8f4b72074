"""Resolve the camera poses a checkpoint is rendered from (port of
``nerf_tpu/data/eval_poses.py``).

Ported: blender scenes without an on-disk dataset (the standard 40-pose
orbit at the config's intrinsics, or 400 px) and the procedural synthetic
scene. Blender scenes with a dataset on disk and LLFF scenes need the
dataset loaders, which are not ported yet: they raise.
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

from .poses import spherical_render_poses

_BLENDER_FOV = 0.6911112070083618


def resolve_render_poses(cfg, split: str = "render") -> Tuple[np.ndarray, int, int, float]:
    """Return ``(poses (N, 3, 4) float32, height, width, focal)``.

    ``split``: ``render`` = the dataset's orbit trajectory; ``train``/``val``/
    ``test`` = that split's camera poses, which need an on-disk dataset.
    """
    ds = cfg.dataset
    if ds.type == "blender":
        if ds.basedir and os.path.isdir(ds.basedir):
            raise NotImplementedError(
                f"dataset.basedir={ds.basedir!r} is a blender dataset on disk; its "
                "loader (data/blender.py) is not ported yet (ROADMAP.md, open items "
                "§1 item 6). Point dataset.basedir elsewhere to render the orbit."
            )
        if split != "render":
            # A split without a dataset would silently become the orbit.
            raise ValueError(
                f"--split {split} needs an on-disk dataset, but "
                f"dataset.basedir={ds.basedir!r} is not a directory"
            )
        h = int(getattr(ds, "height", 400))
        w = int(getattr(ds, "width", 400))
        focal = float(getattr(ds, "focal", 0.5 * w / np.tan(0.5 * _BLENDER_FOV)))
        render_poses = spherical_render_poses(40, phi=-30.0, radius=4.0)
    elif ds.type == "llff":
        raise NotImplementedError(
            "LLFF poses need data/llff.py, which is not ported yet "
            "(ROADMAP.md, open items §1 item 6)"
        )
    elif ds.type == "synthetic":
        if split != "render":
            raise ValueError(
                "--split train/val/test is not defined for the procedural "
                "synthetic dataset (it has no on-disk splits); use the "
                "default --split render"
            )
        h = w = int(getattr(ds, "image_size", 64))
        focal = 0.5 * w / np.tan(0.5 * _BLENDER_FOV)
        render_poses = spherical_render_poses(40, phi=-30.0, radius=4.0)
    else:
        raise ValueError(f"Unsupported dataset type {ds.type!r} for eval")
    return np.asarray(render_poses, np.float32)[:, :3, :4], h, w, focal

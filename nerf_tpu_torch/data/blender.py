"""Blender synthetic-scene loader (port of ``nerf_tpu/data/blender.py``).

Reads ``transforms_{train,val,test}.json`` and their RGBA PNGs (the stdlib
decoder, ``utils/png.py``), keeps all four channels in [0, 1] float32,
strides val/test by ``testskip``, takes the focal length from
``camera_angle_x`` and the 40-pose orbit as render path. ``half_res`` halves
the images (area resize, ``utils/resize.py``) and the focal length;
``debug`` shrinks them 32 times.
"""

from __future__ import annotations

import json
import os
from typing import List, Tuple

import numpy as np

from ..utils.png import read_png
from ..utils.resize import resize_area
from .poses import spherical_render_poses


def load_blender_data(basedir: str, half_res: bool = False, testskip: int = 1,
                      debug: bool = False
                      ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[float], List[np.ndarray]]:
    """Load a blender scene: (imgs (N, H, W, 4), poses (N, 4, 4),
    render_poses (40, 4, 4), [H, W, focal], [i_train, i_val, i_test])."""
    splits = ["train", "val", "test"]
    metas = {}
    for s in splits:
        with open(os.path.join(basedir, f"transforms_{s}.json")) as fp:
            metas[s] = json.load(fp)

    all_imgs, all_poses, counts = [], [], [0]
    for s in splits:
        skip = 1 if s == "train" or testskip == 0 else testskip
        frames = metas[s]["frames"][::skip]
        imgs = np.array([
            (read_png(os.path.join(basedir, frame["file_path"] + ".png")) / 255.0).astype(np.float32)
            for frame in frames])
        poses = np.array([np.array(frame["transform_matrix"]) for frame in frames]).astype(np.float32)
        counts.append(counts[-1] + imgs.shape[0])
        all_imgs.append(imgs)
        all_poses.append(poses)

    i_split = [np.arange(counts[i], counts[i + 1]) for i in range(3)]
    imgs = np.concatenate(all_imgs, 0)
    poses = np.concatenate(all_poses, 0)

    height, width = imgs[0].shape[:2]
    focal = 0.5 * width / np.tan(0.5 * float(metas["train"]["camera_angle_x"]))
    render_poses = spherical_render_poses(40, phi=-30.0, radius=4.0)

    factor = 32 if debug else 2 if half_res else 1
    if factor > 1:
        height, width, focal = height // factor, width // factor, focal / float(factor)
        imgs = np.stack([resize_area(img, (width, height)) for img in imgs], axis=0)
    return imgs, poses, render_poses, [height, width, focal], i_split


def composite_white_background(imgs: np.ndarray) -> np.ndarray:
    """Alpha-composite RGBA images onto white; RGB images pass through."""
    if imgs.shape[-1] == 4:
        return imgs[..., :3] * imgs[..., -1:] + (1.0 - imgs[..., -1:])
    return imgs

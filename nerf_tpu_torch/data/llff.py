"""LLFF (real forward-facing) scene loader (port of ``nerf_tpu/data/llff.py``).

``poses_bounds.npy`` (N, 17) unpacks into (3, 5) poses and two bounds; the
rotation axes swap from [down, right, back] to [right, up, back]; poses and
bounds scale by 1 / (min bound * bd_factor); poses recenter about their
average; the render path is the 120-view, 2-rotation spiral at the 90th
percentile radii (or the spherified circle); the holdout view is the one
nearest the average pose. ``recenter_poses`` and ``spherify_poses`` keep the
reference's arithmetic step for step: NDC rendering depends on these poses to
the last bit.

``images_{factor}/`` (or ``images_{w}x{h}/``) directories are made on demand
from ``images/`` by area resizing (``utils/resize.py``) and written as PNG,
the layout the reference's ImageMagick step leaves. PNGs are read by the
stdlib decoder; other formats (the JPGs of original LLFF captures) need
``imageio``, imported only then; without it :class:`ImageReaderMissing`
says to supply the ``images_{factor}/`` PNGs, which published LLFF scenes
ship.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np

from ..utils.png import read_png, write_png
from ..utils.resize import resize_area
from .poses import normalize, poses_avg, render_path_spiral

_IMG_EXTS = ("JPG", "jpg", "png", "jpeg", "PNG")


class ImageReaderMissing(RuntimeError):
    """An image that is not a PNG, and no ``imageio`` to read it."""


def _imread(path: str) -> np.ndarray:
    """An image's pixels as ``imageio.v2.imread`` gives them; PNGs by the
    stdlib decoder (which, like the reference's ``ignoregamma=True``, applies
    no gamma), anything else by ``imageio``."""
    if path.lower().endswith("png"):
        return read_png(path)
    try:
        import imageio.v2 as imageio
    except ImportError:
        raise ImageReaderMissing(
            f"{path}: reading this format needs imageio, which is not installed; supply the "
            "downsampled images as PNGs (images_{factor}/, as published LLFF scenes ship "
            "them) instead") from None
    return imageio.imread(path)


def _list_images(imgdir: str):
    return [os.path.join(imgdir, f) for f in sorted(os.listdir(imgdir)) if f.endswith(_IMG_EXTS)]


def _minify(basedir: str, factors=(), resolutions=()) -> None:
    """Create the downsampled directories ``images_{r}`` / ``images_{w}x{h}``
    that do not exist yet: each image of ``images/`` area-resized to
    ``round(w / r) x round(h / r)`` (or to ``w x h``), as PNG."""
    todo = [("factor", r) for r in factors
            if not os.path.exists(os.path.join(basedir, f"images_{r}"))]
    todo += [("resolution", r) for r in resolutions
             if not os.path.exists(os.path.join(basedir, f"images_{r[1]}x{r[0]}"))]
    if not todo:
        return
    imgs = _list_images(os.path.join(basedir, "images"))
    for kind, r in todo:
        imgdir = os.path.join(basedir, f"images_{r}" if kind == "factor" else
                              f"images_{r[1]}x{r[0]}")
        os.makedirs(imgdir, exist_ok=True)
        print(f"Minifying {r} {basedir}")
        for path in imgs:
            img = _imread(path)
            h, w = img.shape[:2]
            if kind == "factor":
                new_w, new_h = int(round(w / r)), int(round(h / r))
            else:
                new_h, new_w = int(r[0]), int(r[1])
            base = os.path.splitext(os.path.basename(path))[0]
            write_png(os.path.join(imgdir, base + ".png"), resize_area(img, (new_w, new_h)))


def _load_data(basedir: str, factor: Optional[int] = None, width: Optional[int] = None,
               height: Optional[int] = None, load_imgs: bool = True):
    poses_arr = np.load(os.path.join(basedir, "poses_bounds.npy"))
    poses = poses_arr[:, :-2].reshape([-1, 3, 5]).transpose([1, 2, 0])
    bds = poses_arr[:, -2:].transpose([1, 0])

    sfx = ""
    if factor is not None and factor != 1:
        sfx = f"_{factor}"
        _minify(basedir, factors=[factor])
    elif height is not None or width is not None:
        # Only these two need the original size.
        sh = _imread(_list_images(os.path.join(basedir, "images"))[0]).shape
        if height is not None:
            factor = sh[0] / float(height)
            width = int(sh[1] / factor)
        else:
            factor = sh[1] / float(width)
            height = int(sh[0] / factor)
        _minify(basedir, resolutions=[[height, width]])
        sfx = f"_{width}x{height}"
    else:
        factor = 1

    imgdir = os.path.join(basedir, "images" + sfx)
    if not os.path.exists(imgdir):
        raise FileNotFoundError(f"{imgdir} does not exist")
    imgfiles = _list_images(imgdir)
    if poses.shape[-1] != len(imgfiles):
        raise ValueError(f"Mismatch between imgs {len(imgfiles)} and poses {poses.shape[-1]}")

    first = _imread(imgfiles[0])
    poses[:2, 4, :] = np.array(first.shape[:2]).reshape([2, 1])
    poses[2, 4, :] = poses[2, 4, :] * 1.0 / factor
    if not load_imgs:
        return poses, bds
    imgs = [(first if i == 0 else _imread(f))[..., :3] / 255.0 for i, f in enumerate(imgfiles)]
    return poses, bds, np.stack(imgs, -1)


def recenter_poses(poses: np.ndarray) -> np.ndarray:
    """Transform all poses so that their average pose is the identity."""
    poses_ = poses + 0
    bottom = np.reshape([0, 0, 0, 1.0], [1, 4])
    c2w = poses_avg(poses)
    c2w = np.concatenate([c2w[:3, :4], bottom], -2)
    bottom = np.tile(np.reshape(bottom, [1, 1, 4]), [poses.shape[0], 1, 1])
    poses_h = np.concatenate([poses[:, :3, :4], bottom], -2)
    poses_h = np.linalg.inv(c2w) @ poses_h
    poses_[:, :3, :4] = poses_h[:, :3, :4]
    return poses_


def spherify_poses(poses: np.ndarray, bds: np.ndarray):
    """Re-center 360-degree captures onto a unit sphere; a circular render
    path. Returns (poses, render_poses, bds)."""

    def p34_to_44(p):
        return np.concatenate(
            [p, np.tile(np.reshape(np.eye(4)[-1, :], [1, 1, 4]), [p.shape[0], 1, 1])], 1)

    rays_d = poses[:, :3, 2:3]
    rays_o = poses[:, :3, 3:4]
    # The point nearest (least squares) to every camera axis.
    A_i = np.eye(3) - rays_d * np.transpose(rays_d, [0, 2, 1])
    b_i = -A_i @ rays_o
    pt_mindist = np.squeeze(
        -np.linalg.inv((np.transpose(A_i, [0, 2, 1]) @ A_i).mean(0)) @ b_i.mean(0))

    center = pt_mindist
    up = (poses[:, :3, 3] - center).mean(0)
    vec0 = normalize(up)
    vec1 = normalize(np.cross([0.1, 0.2, 0.3], vec0))
    vec2 = normalize(np.cross(vec0, vec1))
    c2w = np.stack([vec1, vec2, vec0, center], 1)

    poses_reset = np.linalg.inv(p34_to_44(c2w[None])) @ p34_to_44(poses[:, :3, :4])
    rad = np.sqrt(np.mean(np.sum(np.square(poses_reset[:, :3, 3]), -1)))
    sc = 1.0 / rad
    poses_reset[:, :3, 3] *= sc
    bds = bds * sc
    rad *= sc

    centroid = np.mean(poses_reset[:, :3, 3], 0)
    zh = centroid[2]
    radcircle = np.sqrt(rad ** 2 - zh ** 2)
    new_poses = []
    for th in np.linspace(0.0, 2.0 * np.pi, 120):
        camorigin = np.array([radcircle * np.cos(th), radcircle * np.sin(th), zh])
        up = np.array([0, 0, -1.0])
        vec2 = normalize(camorigin)
        vec0 = normalize(np.cross(vec2, up))
        vec1 = normalize(np.cross(vec2, vec0))
        new_poses.append(np.stack([vec0, vec1, vec2, camorigin], 1))
    new_poses = np.stack(new_poses, 0)

    new_poses = np.concatenate(
        [new_poses, np.broadcast_to(poses[0, :3, -1:], new_poses[:, :3, -1:].shape)], -1)
    poses_reset = np.concatenate(
        [poses_reset[:, :3, :4],
         np.broadcast_to(poses[0, :3, -1:], poses_reset[:, :3, -1:].shape)], -1)
    return poses_reset, new_poses, bds


def llff_holdout_split(num_images: int, llffhold: int = 8, i_holdout: int = 0):
    """The LLFF train/holdout split: every ``llffhold``-th view held out (val
    and test alike); ``llffhold <= 0`` holds out the loader's view nearest
    the average pose, ``i_holdout``. Returns ``(i_train, i_test)``."""
    if llffhold > 0:
        i_test = np.arange(num_images)[::llffhold]
    else:
        i_test = np.array([i_holdout])
    i_train = np.array([i for i in range(num_images) if i not in i_test])
    return i_train, i_test


def load_llff_data(basedir: str, factor: int = 8, recenter: bool = True,
                   bd_factor: float = 0.75, spherify: bool = False, path_zflat: bool = False
                   ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray, int]:
    """Load an LLFF scene: (images (N, H, W, 3), poses (N, 3, 5), bds (N, 2),
    render_poses, i_test)."""
    poses, bds, imgs = _load_data(basedir, factor=factor)

    # Axis swap: [down, right, back] -> [right, up, back].
    poses = np.concatenate([poses[:, 1:2, :], -poses[:, 0:1, :], poses[:, 2:, :]], 1)
    poses = np.moveaxis(poses, -1, 0).astype(np.float32)
    images = np.moveaxis(imgs, -1, 0).astype(np.float32)
    bds = np.moveaxis(bds, -1, 0).astype(np.float32)

    sc = 1.0 if bd_factor is None else 1.0 / (bds.min() * bd_factor)
    poses[:, :3, 3] *= sc
    bds = bds * sc

    if recenter:
        poses = recenter_poses(poses)

    if spherify:
        poses, render_poses, bds = spherify_poses(poses, bds)
    else:
        c2w = poses_avg(poses)
        up = normalize(poses[:, :3, 1].sum(0))
        close_depth, inf_depth = bds.min() * 0.9, bds.max() * 5.0
        dt = 0.75
        focal = 1.0 / (((1.0 - dt) / close_depth + dt / inf_depth))
        tt = poses[:, :3, 3]
        rads = np.percentile(np.abs(tt), 90, 0)
        c2w_path = c2w
        N_views, N_rots = 120, 2
        if path_zflat:
            zloc = -close_depth * 0.1
            c2w_path[:3, 3] = c2w_path[:3, 3] + zloc * c2w_path[:3, 2]
            rads[2] = 0.0
            N_rots = 1
            N_views = N_views // 2
        render_poses = render_path_spiral(c2w_path, up, rads, focal, zrate=0.5, rots=N_rots,
                                          N=N_views)
    render_poses = np.array(render_poses).astype(np.float32)

    c2w = poses_avg(poses)
    dists = np.sum(np.square(c2w[:3, 3] - poses[:, :3, 3]), -1)
    i_test = int(np.argmin(dists))
    return images.astype(np.float32), poses.astype(np.float32), bds, render_poses, i_test

"""The port's blender and LLFF loaders (``nerf_tpu_torch/data``) against the
JAX package's on fixtures written as ``tests/test_data.py`` writes them
(imageio PNGs, ``transforms_*.json``, ``poses_bounds.npy``).

Poses, render poses, hwf, splits and bounds must be bitwise; images equal
where no resize runs, and within the area resize's float32 tolerance (1e-6)
where one does (blender half_res/debug resize float32 images; LLFF's
``_minify`` resizes uint8 and is bitwise, so its images are too). Each
package loads its own copy of an LLFF fixture, since ``_minify`` writes
``images_{factor}/`` into the scene. ``resolve_render_poses`` is held to the
JAX function for every split, and the whole loader path runs with ``cv2``
and ``imageio`` unimportable.
"""

import json
import os
import shutil
import sys

import imageio.v2 as imageio
import numpy as np
import pytest

from nerf_tpu.config import load_config as jax_load_config
from nerf_tpu.data import load_blender_data as jax_load_blender
from nerf_tpu.data import load_llff_data as jax_load_llff
from nerf_tpu.data import pose_spherical
from nerf_tpu.data.eval_poses import resolve_render_poses as jax_resolve
from nerf_tpu.data.llff import llff_holdout_split as jax_holdout
from nerf_tpu.data.poses import normalize as jax_normalize
from nerf_tpu.data.poses import poses_avg as jax_poses_avg
from nerf_tpu.data.poses import render_path_spiral as jax_spiral
from nerf_tpu.data.poses import viewmatrix as jax_viewmatrix
from nerf_tpu_torch.config import load_config
from nerf_tpu_torch.data import (
    ImageReaderMissing,
    composite_white_background,
    llff_holdout_split,
    load_blender_data,
    load_llff_data,
    load_render_split,
    resolve_render_poses,
)
from nerf_tpu_torch.data import poses as tposes

RESIZE_TOL = 1e-6


def write_blender(root, size=64, counts=(("train", 3), ("val", 2), ("test", 2)), seed=0):
    rng = np.random.default_rng(seed)
    for split, n in counts:
        frames = []
        os.makedirs(os.path.join(root, split), exist_ok=True)
        for i in range(n):
            img = rng.uniform(0, 255, (size, size, 4)).astype(np.uint8)
            imageio.imwrite(os.path.join(root, split, f"r_{i}.png"), img)
            pose = pose_spherical(i * 40.0 + 7.0 * len(split), -30.0, 4.0)
            frames.append({"file_path": f"./{split}/r_{i}", "transform_matrix": pose.tolist()})
        with open(os.path.join(root, f"transforms_{split}.json"), "w") as f:
            json.dump({"camera_angle_x": 0.6911112070083618, "frames": frames}, f)
    return str(root)


def write_llff(root, n=9, h=36, w=44, seed=0, ext="png"):
    """``n`` forward-facing views: raw LLFF poses ([down, right, back], the
    loader's swap undone) and bounds, images under ``images/``."""
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "images"), exist_ok=True)
    for i in range(n):
        imageio.imwrite(os.path.join(root, "images", f"img_{i:03d}.{ext}"),
                        rng.uniform(0, 255, (h, w, 3)).astype(np.uint8))
    poses = np.zeros((n, 3, 5), np.float32)
    for i in range(n):
        c2w = pose_spherical(5.0 * i - 20.0, -5.0 - 1.5 * i, 4.0)[:3, :4]
        poses[i, :, :4] = np.concatenate([-c2w[:, 1:2], c2w[:, 0:1], c2w[:, 2:]], 1)
        poses[i, :, 4] = [h, w, 40.0]
    bds = np.stack([np.full(n, 2.0) + 0.1 * np.arange(n), np.full(n, 8.0)], -1)
    np.save(os.path.join(root, "poses_bounds.npy"),
            np.concatenate([poses.reshape(n, -1), bds], -1))
    return str(root)


@pytest.fixture(scope="module")
def blender_dir(tmp_path_factory):
    return write_blender(tmp_path_factory.mktemp("blender"))


def _equal_list(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kw", [{}, {"half_res": True}, {"testskip": 2},
                                {"half_res": True, "testskip": 0}, {"debug": True}],
                         ids=["full", "half_res", "testskip2", "half_res-testskip0", "debug"])
def test_blender_loader_matches_jax(blender_dir, kw):
    imgs, poses, render_poses, hwf, i_split = load_blender_data(blender_dir, **kw)
    w_imgs, w_poses, w_render, w_hwf, w_split = jax_load_blender(blender_dir, **kw)
    assert imgs.dtype == w_imgs.dtype == np.float32 and imgs.shape == w_imgs.shape
    tol = 0 if kw in ({}, {"testskip": 2}) else RESIZE_TOL
    np.testing.assert_allclose(imgs, w_imgs, rtol=0, atol=tol)
    _equal_list([poses, render_poses], [w_poses, w_render])
    assert hwf == w_hwf and type(hwf[2]) is type(w_hwf[2])
    _equal_list(i_split, w_split)
    # rgb * a + (1 - a): each input's error (at most tol) enters up to 3 times.
    np.testing.assert_allclose(composite_white_background(imgs),
                               composite_white_background(w_imgs), rtol=0, atol=3 * tol)


def test_pose_helpers_are_bitwise_jax():
    rng = np.random.default_rng(3)
    poses = np.concatenate([rng.normal(size=(6, 3, 4)), np.full((6, 3, 1), 5.0)], -1)
    np.testing.assert_array_equal(tposes.poses_avg(poses), jax_poses_avg(poses))
    z, up, pos = rng.normal(size=(3, 3))
    np.testing.assert_array_equal(tposes.viewmatrix(z, up, pos), jax_viewmatrix(z, up, pos))
    np.testing.assert_array_equal(tposes.normalize(z), jax_normalize(z))
    c2w = jax_poses_avg(poses)
    _equal_list(tposes.render_path_spiral(c2w, up, [0.3, 0.2, 0.1], 4.2, 0.5, 2, 17),
                jax_spiral(c2w, up, [0.3, 0.2, 0.1], 4.2, 0.5, 2, 17))


LLFF_CASES = [
    ({"factor": 1}, {}),
    ({"factor": 2}, {}),
    ({"factor": 8}, {"h": 75, "w": 100}),     # round(100 / 8) x round(75 / 8) = 12 x 9
    ({"factor": 1, "spherify": True}, {}),
    ({"factor": 1, "path_zflat": True}, {}),
    ({"factor": 2, "recenter": False, "bd_factor": 0.5}, {}),
]


@pytest.mark.parametrize("kw,shape", LLFF_CASES,
                         ids=["f1", "f2-minify", "f8-minify-odd", "spherify", "zflat",
                              "no-recenter"])
def test_llff_loader_matches_jax(tmp_path, kw, shape):
    ours = write_llff(tmp_path / "ours", **shape)
    theirs = shutil.copytree(ours, tmp_path / "theirs")
    images, poses, bds, render_poses, i_test = load_llff_data(ours, **kw)
    w_images, w_poses, w_bds, w_render, w_i_test = jax_load_llff(str(theirs), **kw)
    assert images.dtype == np.float32 and images.shape == w_images.shape
    np.testing.assert_array_equal(images, w_images)
    _equal_list([poses, bds, render_poses], [w_poses, w_bds, w_render])
    assert i_test == w_i_test
    factor = kw["factor"]
    if factor > 1:
        sub = f"images_{factor}"
        for name in sorted(os.listdir(os.path.join(theirs, sub))):
            np.testing.assert_array_equal(imageio.imread(os.path.join(ours, sub, name)),
                                          imageio.imread(os.path.join(theirs, sub, name)))


@pytest.mark.parametrize("n,hold,i_holdout", [(9, 8, 0), (9, 3, 0), (9, 0, 4), (1, 8, 0)])
def test_llff_holdout_split_matches_jax(n, hold, i_holdout):
    _equal_list(llff_holdout_split(n, hold, i_holdout), jax_holdout(n, hold, i_holdout))


def _cfg_yaml(tmp_path, dataset: dict):
    lines = ["dataset:"] + [f"  {k}: {v}" for k, v in dataset.items()]
    path = tmp_path / "cfg.yml"
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("split", ["render", "train", "val", "test"])
def test_resolve_render_poses_matches_jax_blender(blender_dir, tmp_path, split):
    cfg = _cfg_yaml(tmp_path, {"type": "blender", "basedir": blender_dir, "half_res": True,
                               "testskip": 2})
    got = resolve_render_poses(load_config(cfg), split)
    want = jax_resolve(jax_load_config(cfg), split)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]
    truth = load_render_split(load_config(cfg), split, white_background=True).images
    if split == "render":
        assert truth is None
    else:
        imgs, _, _, _, i_split = jax_load_blender(blender_dir, half_res=True, testskip=2)
        want_imgs = composite_white_background(imgs[i_split[("train", "val", "test")
                                                            .index(split)]])
        np.testing.assert_allclose(truth, want_imgs, rtol=0, atol=3 * RESIZE_TOL)


@pytest.mark.parametrize("split", ["render", "train", "val", "test"])
@pytest.mark.parametrize("llffhold", [8, 0])
def test_resolve_render_poses_matches_jax_llff(tmp_path, split, llffhold):
    ours = write_llff(tmp_path / "ours")
    theirs = str(shutil.copytree(ours, tmp_path / "theirs"))
    ds = {"type": "llff", "downsample_factor": 2, "llffhold": llffhold}
    got = resolve_render_poses(load_config(_cfg_yaml(tmp_path, {**ds, "basedir": ours})), split)
    want = jax_resolve(jax_load_config(_cfg_yaml(tmp_path, {**ds, "basedir": theirs})), split)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]


def test_loaders_run_without_cv2_and_imageio(blender_dir, tmp_path, monkeypatch):
    """The whole loader path, minify included, with ``cv2`` and ``imageio``
    unimportable, against the JAX loaders run before they were blocked."""
    llff = write_llff(tmp_path / "ours")
    theirs = str(shutil.copytree(llff, tmp_path / "theirs"))
    want_b = jax_load_blender(blender_dir, half_res=True)
    want_l = jax_load_llff(theirs, factor=2)
    for name in ("cv2", "imageio", "imageio.v2", "imageio.v3"):
        monkeypatch.setitem(sys.modules, name, None)
    with pytest.raises(ImportError):
        import imageio.v2  # noqa: F401
    got_b = load_blender_data(blender_dir, half_res=True)
    np.testing.assert_allclose(got_b[0], want_b[0], rtol=0, atol=RESIZE_TOL)
    _equal_list(got_b[1:2], want_b[1:2])
    got_l = load_llff_data(llff, factor=2)
    np.testing.assert_array_equal(got_l[0], want_l[0])
    _equal_list(got_l[1:4], want_l[1:4])


def test_llff_jpgs_need_imageio_or_pngs(tmp_path, monkeypatch):
    """Original LLFF images are JPGs: without imageio the loader names the
    missing reader and the PNG directory to supply; with ``images_2/`` PNGs
    there (as published scenes ship them) it loads without reading a JPG."""
    scene = write_llff(tmp_path / "jpg", ext="jpg")
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    with pytest.raises(ImageReaderMissing, match="images_"):
        load_llff_data(scene, factor=2)
    shutil.rmtree(os.path.join(scene, "images_2"), ignore_errors=True)
    monkeypatch.undo()
    jax_images = jax_load_llff(str(shutil.copytree(scene, tmp_path / "theirs")), factor=2)[0]
    shutil.copytree(tmp_path / "theirs" / "images_2", os.path.join(scene, "images_2"))
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v2", None)
    np.testing.assert_array_equal(load_llff_data(scene, factor=2)[0], jax_images)

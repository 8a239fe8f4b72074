"""nerf_tpu_torch.distill_dataset against the JAX CLI, and its output through
the port's loaders.

- ``random_hemisphere_poses``, ``forward_facing_poses`` and
  ``write_llff_poses_bounds`` are numpy in both packages: bitwise equal
  arrays and file bytes from the same seeds.
- Both CLIs distill the same ``.ntc`` teacher (a narrow FlexibleNeRF) into a
  blender set and an LLFF set at 16 px: the same file names,
  ``transforms_*.json`` and ``poses_bounds.npy`` byte for byte, each view's
  float render within 1e-5 of JAX's and its PNG within one level (the uint8
  cast truncates, so a value on a level boundary may round either way).
- Round trip: ``data/blender.py`` reads the blender set back (poses equal
  to the JSON's, images the PNGs / 255, as the JAX loader reads them) and
  ``data/llff.py`` the LLFF set, whose recentre and rescale give the
  written poses back to 1e-5, as the JAX loader does.
"""

import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import distill_dataset as jdistill
from nerf_tpu.config import load_config as jax_load_config
from nerf_tpu.config import render_settings_from_config as jax_settings_from_config
from nerf_tpu.data import load_blender_data as jax_load_blender
from nerf_tpu.data import load_llff_data as jax_load_llff
from nerf_tpu.engine.renderer import make_pose_render_fn as jax_pose_render_fn
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch import distill_dataset
from nerf_tpu_torch.config import load_config, render_settings_from_config
from nerf_tpu_torch.data import load_blender_data, load_llff_data
from nerf_tpu_torch.engine.checkpoint import load_models_and_params, save_checkpoint
from nerf_tpu_torch.engine.renderer import make_pose_render_fn
from nerf_tpu_torch.utils.png import read_png

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(num_layers=2, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=3,
              num_encoding_fn_dir=2)
SIZE = 16

CFG_YML = """
experiment: {{id: distill, logdir: {logdir}}}
dataset: {{type: {kind}, basedir: "", half_res: false, no_ndc: {no_ndc}, near: {near},
          far: {far}, llffhold: 8}}
models:
  coarse: {{type: FlexibleNeRFModel, num_layers: 2, hidden_size: 16, skip_connect_every: 3,
           num_encoding_fn_xyz: 3, num_encoding_fn_dir: 2, use_viewdirs: true}}
  fine: {{type: FlexibleNeRFModel, num_layers: 2, hidden_size: 16, skip_connect_every: 3,
         num_encoding_fn_xyz: 3, num_encoding_fn_dir: 2, use_viewdirs: true}}
nerf:
  use_viewdirs: true
  train: {{num_random_rays: 16, chunksize: 4096, perturb: true, num_coarse: 8, num_fine: 8,
          white_background: {white}, radiance_field_noise_std: 0.2, lindisp: false}}
  validation: {{chunksize: 4096, perturb: false, num_coarse: 8, num_fine: 8,
               white_background: {white}, radiance_field_noise_std: 0.0, lindisp: false}}
"""
KINDS = {"blender": dict(no_ndc="true", near=2.0, far=6.0, white="true"),
         "llff": dict(no_ndc="false", near=0.0, far=1.0, white="false")}
FLAGS = {"blender": ["--num-train", "3", "--num-val", "2", "--num-test", "1"],
         "llff": ["--num-train", "7", "--num-val", "2"]}


@pytest.mark.parametrize("seed", [0, 2026])
def test_poses_and_bounds_bitwise(seed, tmp_path):
    for n in (1, 5):
        np.testing.assert_array_equal(
            distill_dataset.random_hemisphere_poses(np.random.default_rng(seed), n),
            jdistill.random_hemisphere_poses(np.random.default_rng(seed), n))
        got = distill_dataset.forward_facing_poses(np.random.default_rng(seed), n + 4)
        want = jdistill.forward_facing_poses(np.random.default_rng(seed), n + 4)
        assert got.dtype == want.dtype and got.shape == (n + 4, 3, 4)
        np.testing.assert_array_equal(got, want)
    poses = jdistill.forward_facing_poses(np.random.default_rng(seed), 9)
    for mod, d in ((distill_dataset, tmp_path / "t"), (jdistill, tmp_path / "j")):
        d.mkdir()
        mod.write_llff_poses_bounds(str(d), poses, (12, 16, 12.9), (4.0 / 3.0, 8.0))
    assert ((tmp_path / "t" / "poses_bounds.npy").read_bytes()
            == (tmp_path / "j" / "poses_bounds.npy").read_bytes())


@pytest.fixture(scope="module")
def teacher(tmp_path_factory):
    d = tmp_path_factory.mktemp("distill")
    jmodel = JaxFlexible(**NARROW)
    pc, pf = jmodel.init(jax.random.PRNGKey(3)), jmodel.init(jax.random.PRNGKey(4))
    ckpt = str(d / "teacher.ntc")
    save_checkpoint(ckpt, {"step": 7, "params_coarse": jax.tree.map(np.asarray, pc),
                           "params_fine": jax.tree.map(np.asarray, pf)})
    cfgs = {}
    for kind, kw in KINDS.items():
        path = d / f"{kind}.yml"
        path.write_text(CFG_YML.format(logdir=str(d / "logs"), kind=kind, **kw))
        cfgs[kind] = str(path)
    return d, ckpt, cfgs


def _run_jax_cli(argv, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    module = importlib.import_module("distill_dataset")
    monkeypatch.setattr(sys, "argv", ["distill_dataset.py", *argv])
    module.main()


def _files(root):
    return sorted(os.path.relpath(os.path.join(dp, f), root)
                  for dp, _, fs in os.walk(root) for f in fs)


def _f32_renders(cfg_path, ckpt, poses, h, w, focal):
    """Each pose's float render by both packages' renderers."""
    cfg = load_config(cfg_path)
    mc, mf, _ = load_models_and_params(ckpt, cfg, "cpu")
    render = make_pose_render_fn(mc, mf, render_settings_from_config(
        cfg, "validation", hwf=(h, w, focal)), h, w, focal, output="f32")
    from nerf_tpu.engine.checkpoint import load_models_and_params as jax_load

    jcfg = jax_load_config(cfg_path)
    jc, jf, pc, pf, _ = jax_load(ckpt, jcfg)
    jrender = jax_pose_render_fn(jc, jf, jax_settings_from_config(
        jcfg, "validation", hwf=(h, w, focal)), h, w, focal, output="f32")
    for pose in poses:
        with torch.no_grad():
            got = render(torch.as_tensor(np.asarray(pose)[:3, :4], dtype=torch.float32))
        want = jrender(pc, pf, jnp.asarray(np.asarray(pose)[:3, :4], jnp.float32))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)


@pytest.mark.parametrize("kind", ["blender", "llff"])
def test_distill_matches_the_jax_cli(kind, teacher, monkeypatch):
    d, ckpt, cfgs = teacher
    args = ["--config", cfgs[kind], "--checkpoint", ckpt, "--size", str(SIZE), "--seed", "5",
            *FLAGS[kind]]
    _run_jax_cli([*args, "--savedir", str(d / f"jax_{kind}")], monkeypatch)
    result = distill_dataset.main([*args, "--savedir", str(d / f"port_{kind}"),
                                   "--device", "cpu"])
    port, jaxd = d / f"port_{kind}", d / f"jax_{kind}"
    assert _files(port) == _files(jaxd)
    assert result.views == (6 if kind == "blender" else 9)
    same_bytes = [f for f in _files(port) if f.endswith((".json", ".npy"))]
    assert len(same_bytes) == (3 if kind == "blender" else 1)
    for f in same_bytes:
        assert (port / f).read_bytes() == (jaxd / f).read_bytes(), f
    for f in _files(port):
        if f.endswith(".png"):
            got, want = read_png(str(port / f)).astype(int), read_png(str(jaxd / f)).astype(int)
            assert got.shape == want.shape and np.abs(got - want).max() <= 1, f
    if kind == "blender":
        with open(port / "transforms_train.json") as fh:
            poses = [np.asarray(fr["transform_matrix"]) for fr in json.load(fh)["frames"]]
        focal = 0.5 * SIZE / np.tan(0.5 * distill_dataset.BLENDER_CAMERA_ANGLE_X)
        _f32_renders(cfgs[kind], ckpt, poses, SIZE, SIZE, focal)
    else:
        poses = jdistill.forward_facing_poses(np.random.default_rng(5), 9)
        h = int(round(SIZE * distill_dataset.LLFF_ASPECT))
        _f32_renders(cfgs[kind], ckpt, poses[:3], h, SIZE, SIZE * distill_dataset.LLFF_FOCAL_RATIO)


def test_round_trip_through_the_loaders(teacher, monkeypatch):
    d, ckpt, cfgs = teacher
    blender, llff = d / "rt_blender", d / "rt_llff"
    distill_dataset.main(["--config", cfgs["blender"], "--checkpoint", ckpt, "--size", str(SIZE),
                          "--savedir", str(blender), "--device", "cpu", *FLAGS["blender"]])
    distill_dataset.main(["--config", cfgs["llff"], "--checkpoint", ckpt, "--size", str(SIZE),
                          "--savedir", str(llff), "--device", "cpu", *FLAGS["llff"]])
    imgs, poses, _, hwf, i_split = load_blender_data(str(blender))
    jimgs, jposes, _, jhwf, ji_split = jax_load_blender(str(blender))
    np.testing.assert_array_equal(imgs, jimgs)
    np.testing.assert_array_equal(poses, jposes)
    assert [list(x) for x in i_split] == [list(x) for x in ji_split] == [[0, 1, 2], [3, 4], [5]]
    assert hwf[:2] == [SIZE, SIZE] and hwf[2] == pytest.approx(jhwf[2], rel=1e-12)
    with open(blender / "transforms_val.json") as fh:
        want = np.asarray([fr["transform_matrix"] for fr in json.load(fh)["frames"]], np.float32)
    np.testing.assert_array_equal(poses[3:5], want)
    np.testing.assert_array_equal(
        imgs[0], (read_png(str(blender / "train" / "r_0.png")) / 255.0).astype(np.float32))

    images, lposes, bds, _, _ = load_llff_data(str(llff), factor=1)
    jimages, jlposes, jbds, _, _ = jax_load_llff(str(llff), factor=1)
    np.testing.assert_array_equal(images, jimages)
    np.testing.assert_allclose(lposes, jlposes, rtol=0, atol=1e-6)
    written = distill_dataset.forward_facing_poses(np.random.default_rng(2026), 9)
    np.testing.assert_allclose(lposes[:, :3, :4], written, rtol=0, atol=1e-5)
    h = int(round(SIZE * distill_dataset.LLFF_ASPECT))
    np.testing.assert_allclose(lposes[0, :3, 4], [h, SIZE, SIZE * distill_dataset.LLFF_FOCAL_RATIO],
                               rtol=1e-6)
    np.testing.assert_allclose(bds.min(), 4.0 / 3.0, rtol=1e-6)
    np.testing.assert_array_equal(read_png(str(llff / "holdout" / "0001.png")),
                                  read_png(str(llff / "images" / "image008.png")))

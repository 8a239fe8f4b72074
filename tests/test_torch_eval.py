"""The port's eval entry point, config, poses and PNG writer.

``python -m nerf_tpu_torch.eval_nerf`` renders a tiny config from a
reference ``.ckpt`` written by the JAX package, and its maps are held against
the JAX ``make_pose_render_fn`` on the same checkpoint to 1e-4.
"""

import os
import subprocess
import sys

import imageio.v2 as imageio
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nerf_tpu.config import load_config as jax_load_config
from nerf_tpu.config import render_settings_from_config as jax_settings_from_config
from nerf_tpu.data.eval_poses import resolve_render_poses as jax_resolve_render_poses
from nerf_tpu.engine.checkpoint import export_reference_checkpoint
from nerf_tpu.engine.checkpoint import load_models_and_params as jax_load_models
from nerf_tpu.engine.renderer import make_pose_render_fn as jax_pose_render_fn
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch import eval_nerf
from nerf_tpu_torch.config import load_config, render_settings_from_config
from nerf_tpu_torch.data import resolve_render_poses
from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t
from nerf_tpu_torch.utils.png import write_png

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIGS = sorted(f for f in os.listdir(os.path.join(REPO, "configs")) if f.endswith(".yml"))

TINY_YAML = """
dataset:
  type: blender
  basedir: {basedir}
  no_ndc: True
  near: 2
  far: 6
  height: 12
  width: 10
models:
  coarse:
    type: FlexibleNeRFModel
    num_encoding_fn_xyz: 10
    num_encoding_fn_dir: 4
  fine:
    type: FlexibleNeRFModel
    num_encoding_fn_xyz: 10
    num_encoding_fn_dir: 4
nerf:
  validation:
    chunksize: 50
    num_coarse: 8
    num_fine: 8
    white_background: True
"""


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    cfg_path = d / "tiny.yml"
    cfg_path.write_text(TINY_YAML.format(basedir=d / "no_dataset"))
    jmodel = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    ckpt = str(d / "tiny.ckpt")
    export_reference_checkpoint(ckpt, 1, jmodel.init(jax.random.PRNGKey(0)),
                                jmodel.init(jax.random.PRNGKey(1)), loss=0.0, psnr=0.0)
    return str(cfg_path), ckpt, d


def test_eval_cli_matches_jax(tiny, capsys):
    cfg_path, ckpt, d = tiny
    out = d / "rendered"
    before = fused_mlp_t.launches
    result = eval_nerf.main(["--config", cfg_path, "--checkpoint", ckpt, "--savedir", str(out),
                             "--num-poses", "2", "--device", "cpu", "--save-disparity-image"])
    assert fused_mlp_t.launches == before            # CPU tensors: the plain version
    assert "rendered 2 poses at 12x10 on cpu" in capsys.readouterr().out
    assert sorted(os.listdir(out)) == ["0000.png", "0001.png", "disparity"]
    assert all(result.finite)

    cfg = jax_load_config(cfg_path)
    poses, h, w, focal = jax_resolve_render_poses(cfg, "render")
    mc, mf, pc, pf, _ = jax_load_models(ckpt, cfg)
    settings = jax_settings_from_config(cfg, "validation", hwf=(h, w, focal))
    want = jax_pose_render_fn(mc, mf, settings, h, w, focal)(pc, pf, jnp.asarray(poses[0]))
    for key in ("rgb_coarse", "rgb_fine", "disp_fine", "acc_fine", "depth_fine"):
        np.testing.assert_allclose(result.first_maps[key].numpy(), np.asarray(want[key]),
                                   rtol=1e-4, atol=1e-4)
    png = imageio.imread(out / "0000.png")
    np.testing.assert_array_equal(png, result.first_maps["rgb_u8"].numpy())
    assert np.abs(png.astype(int) - np.asarray(want["rgb_u8"]).astype(int)).max() <= 1


@pytest.mark.parametrize("flag,error", [
    (["--gif", "x.gif", "--split", "test"], (ValueError, "on-disk dataset")),
    (["--tighten-aabb", "1.0", "--overrides", "dataset.no_ndc", "False"],
     (SystemExit, "incompatible with NDC")),
    (["--split", "val"], (ValueError, "on-disk dataset")),
])
def test_eval_cli_unported_flags_raise(tiny, flag, error):
    """--tighten-aabb, --gif and --split are ported
    (tests/test_torch_geometry.py, tests/test_torch_eval_split_gif.py);
    --tighten-aabb refuses an NDC scene, and a dataset split of a config
    without a dataset on disk raises, as the JAX CLI does."""
    cfg_path, ckpt, d = tiny
    with pytest.raises(error[0], match=error[1]):
        eval_nerf.main(["--config", cfg_path, "--checkpoint", ckpt, "--savedir",
                        str(d / "x"), "--device", "cpu", *flag])


@pytest.mark.parametrize("shape", [(5, 7), (5, 7, 1), (6, 4, 3), (3, 9, 4)])
def test_png_writer_reads_back(tmp_path, shape):
    img = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    path = str(tmp_path / "img.png")
    write_png(path, img)
    np.testing.assert_array_equal(imageio.imread(path).reshape(shape), img)


def test_png_writer_refuses_other_types(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        write_png(str(tmp_path / "a.png"), np.zeros((2, 2, 3), np.float32))
    with pytest.raises(ValueError, match="H, W"):
        write_png(str(tmp_path / "a.png"), np.zeros((2, 2, 2), np.uint8))


def test_chip_smoke_config_is_lego_fused():
    want = load_config(os.path.join(REPO, "configs", "lego_fused.yml"))
    got = chip_smoke.lego_fused_config()
    for section in ("dataset", "models"):
        assert got[section].to_dict() == want[section].to_dict()
    assert got.nerf.validation.to_dict() == want.nerf.validation.to_dict()
    assert got.nerf.use_viewdirs == want.nerf.use_viewdirs
    for section in ("experiment", "optimizer", "scheduler"):
        assert got[section].to_dict() == want[section].to_dict(), section
    assert got.nerf.train.to_dict() == want.nerf.train.to_dict()
    synthetic = chip_smoke.synthetic_train_config(300)
    assert (synthetic.dataset.type, synthetic.dataset.num_views, synthetic.dataset.image_size,
            synthetic.experiment.train_iters) == ("synthetic", 20, 400, 300)
    assert synthetic.nerf.train.to_dict() == want.nerf.train.to_dict()


@pytest.mark.parametrize("name", CONFIGS)
def test_configs_load_as_in_jax(name):
    path = os.path.join(REPO, "configs", name)
    got, want = load_config(path), jax_load_config(path)
    assert got.to_dict() == want.to_dict()
    hwf = (24, 32, 30.0)
    for mode in ("train", "validation"):
        assert vars(render_settings_from_config(got, mode, hwf)) == vars(
            jax_settings_from_config(want, mode, hwf))


def test_render_poses_match_jax(tiny):
    cfg_path, _, d = tiny
    for overrides in ([], ["dataset.type", "synthetic", "dataset.image_size", 16]):
        got = resolve_render_poses(load_config(cfg_path, overrides))
        want = jax_resolve_render_poses(jax_load_config(cfg_path, overrides), "render")
        np.testing.assert_allclose(got[0], want[0], rtol=1e-6, atol=1e-6)
        assert got[1:] == want[1:]
    # A directory that holds no blender dataset, and an LLFF scene that is
    # not there, fail in both packages alike (the loaders, held to the JAX
    # ones in tests/test_torch_llff_blender.py).
    for overrides in (["dataset.basedir", str(d)], ["dataset.type", "llff"]):
        with pytest.raises(FileNotFoundError):
            jax_resolve_render_poses(jax_load_config(cfg_path, overrides), "render")
        with pytest.raises(FileNotFoundError):
            resolve_render_poses(load_config(cfg_path, overrides))


def test_package_imports_no_jax():
    code = (
        "import importlib, pkgutil, sys\n"
        "import nerf_tpu_torch, chip_smoke\n"
        "for m in pkgutil.walk_packages(nerf_tpu_torch.__path__, 'nerf_tpu_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'optax', 'nerf_tpu'))\n"
        "print(len(sys.modules), bad)\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True,
                          env={**os.environ, "PYTHONPATH": REPO}, timeout=120)
    assert proc.returncode == 0, proc.stderr

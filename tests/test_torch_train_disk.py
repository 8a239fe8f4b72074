"""The port's trainer and cache writer on datasets on disk, against the JAX
package's on the same fixtures, on the CPU.

- ``train_nerf --config configs/lego_fused.yml --overrides dataset.basedir
  <blender fixture> ...`` (the flagship protocol cut to a few rays, samples
  and steps): its store is the JAX ``load_dataset`` + ``build_ray_store``'s
  (origins and directions bitwise, the C++ builder in both; targets within
  3e-6, the float32 half_res resize composited onto white), its first
  step's loss is the loss of the batch it drew, and on that batch, perturb
  and noise off, the JAX loss agrees to rtol 1e-5.
- ``configs/fern.yml`` on an LLFF fixture (minify, NDC, llffhold split).
- ``python -m nerf_tpu_torch.cache_dataset`` writes what the JAX script
  writes: ``.nrc`` bytes, ``.npz`` arrays and meta, and reference-format
  ``.data`` tensors equal on LLFF; on a half_res blender scene the targets
  within 3e-6 (the float32 resize) and all else equal. Training from the
  ``.nrc`` draws the store of the live run bitwise, and the same losses.
"""

import argparse
import dataclasses
import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import cache_dataset as jax_cache
import train_nerf as jax_train_nerf
from nerf_tpu.config import load_config as jax_load_config
from nerf_tpu.config import model_from_config as jax_model_from_config
from nerf_tpu.config import render_settings_from_config as jax_settings
from nerf_tpu.data import build_ray_store as jax_build_ray_store
from nerf_tpu.engine import train as jtrain
from nerf_tpu_torch import cache_dataset, train_nerf
from nerf_tpu_torch.config import load_config, model_from_config, render_settings_from_config
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict
from tests.test_torch_llff_blender import write_blender, write_llff

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["nerf.train.num_random_rays", 64, "nerf.train.num_coarse", 8, "nerf.train.num_fine", 8,
         "nerf.validation.num_coarse", 8, "nerf.validation.num_fine", 8,
         "nerf.validation.chunksize", 4096, "nerf.train.chunksize", 4096,
         "experiment.train_iters", 3, "experiment.save_every", 3, "experiment.print_every", 3,
         "experiment.validate_every", 3]


@pytest.fixture(scope="module")
def blender(tmp_path_factory):
    d = tmp_path_factory.mktemp("disk")
    return write_blender(d / "lego", size=32, counts=(("train", 3), ("val", 2), ("test", 2))), d


def _lego(basedir, logdir, extra=()):
    return ["dataset.basedir", basedir, "experiment.logdir", logdir, *SMALL, *extra]


def test_lego_fused_on_a_blender_dataset_matches_jax(blender):
    basedir, d = blender
    overrides = _lego(basedir, str(d / "logs"))
    cfg_path = os.path.join(REPO, "configs", "lego_fused.yml")
    run = train_nerf.main(["--config", cfg_path, "--device", "cpu", "--overrides",
                           *map(str, overrides)])
    assert run.store_builder == "native" and run.store_rays == 3 * 16 * 16
    assert len(run.losses) == 3 and np.isfinite(run.losses).all() and len(run.val_psnrs) == 1
    assert sorted(f for f in os.listdir(run.logdir) if f.startswith("checkpoint")) == [
        "checkpoint00003.ckpt", "checkpoint00003.ntc"]

    cfg = load_config(cfg_path, overrides)
    data = train_nerf.load_dataset(cfg)
    jcfg = jax_load_config(cfg_path, overrides)
    jdata = jax_train_nerf.load_dataset(jcfg)
    tr = jdata["i_train"]
    h, w, focal = jdata["hwf"]
    want = jax_build_ray_store(jdata["images"][tr], jdata["poses"][tr], h, w, focal)
    assert data["hwf"] == (h, w, focal)
    np.testing.assert_array_equal(data["rays"][0], want[0])
    np.testing.assert_array_equal(data["rays"][1], want[1])
    np.testing.assert_allclose(data["rays"][2], want[2], rtol=0, atol=3e-6)
    np.testing.assert_array_equal(data["val_poses"], jdata["poses"][jdata["i_val"][:1]])
    np.testing.assert_allclose(data["val_images"], jdata["images"][jdata["i_val"][:1]],
                               rtol=0, atol=3e-6)

    # The first step: the trainer's models and batch, its loss recomputed.
    seed = int(cfg.experiment.randomseed)
    models = [model_from_config(cfg.models[k]) for k in ("coarse", "fine")]
    for i, m in enumerate(models):
        m.reset_parameters(torch.Generator().manual_seed(seed + i))
    store = [torch.from_numpy(np.ascontiguousarray(a)) for a in data["rays"]]
    gen = ttrain.step_generator(seed, 0, "cpu")
    idx_gen = ttrain.step_generator(seed, 0, "cpu")
    idx = torch.randint(store[0].shape[0], (64,), generator=idx_gen)
    batch = ttrain.sample_ray_batch(gen, *store, 64)
    settings = render_settings_from_config(cfg, "train", hwf=data["hwf"])
    loss, _ = ttrain.make_loss_fn(*models, settings)(*batch, gen)
    assert float(loss.detach()) == run.losses[0]

    plain = dict(perturb=False, radiance_field_noise_std=0.0, compute_dtype="float32",
                 use_pallas_train=False)
    loss, _ = ttrain.make_loss_fn(*models, dataclasses.replace(settings, **plain))(*batch)
    jmodel = jax_model_from_config(jcfg.models.coarse)
    jsettings = dataclasses.replace(jax_settings(jcfg, "train", hwf=(h, w, focal)), **plain)
    params = {k: convert_torch_state_dict(m.state_dict())
              for k, m in zip(("coarse", "fine"), models)}
    jloss, _ = jtrain.make_loss_fn(jmodel, jmodel, jsettings)(
        params, *(jnp.asarray(a[idx.numpy()]) for a in want), None)
    np.testing.assert_allclose(float(loss.detach()), float(jloss), rtol=1e-5)


def test_fern_on_an_llff_dataset(tmp_path):
    """fern.yml's 4x64 6/4 model, NDC rays, factor 8 (minified here from
    8x-size PNGs) and the llffhold split: finite losses, and the split's
    views render."""
    scene = write_llff(tmp_path / "fern", n=9, h=8 * 12, w=8 * 16)
    cfg_path = os.path.join(REPO, "configs", "fern.yml")
    overrides = ["dataset.basedir", scene, "experiment.logdir", str(tmp_path / "logs"), *SMALL]
    run = train_nerf.main(["--config", cfg_path, "--device", "cpu", "--overrides",
                           *map(str, overrides)])
    assert os.path.isdir(os.path.join(scene, "images_8"))
    assert run.store_rays == 7 * 12 * 16 and np.isfinite(run.losses).all()
    jdata = jax_train_nerf.load_dataset(jax_load_config(cfg_path, overrides))
    assert list(jdata["i_train"]) == [1, 2, 3, 4, 5, 6, 7]
    from nerf_tpu_torch import eval_nerf

    result = eval_nerf.render_trajectory(load_config(cfg_path, overrides), os.path.join(
        run.logdir, "checkpoint00003.ntc"), str(tmp_path / "test"), split="test",
        renderer="plain", device="cpu")
    assert len(result.psnrs) == 2 and all(result.finite)


def _args(datapath, savedir, fmt, kind="blender", **kw):
    base = dict(datapath=datapath, type=kind, savedir=savedir, half_res=True, testskip=1,
                factor=2, llffhold=8, spherify=False, path_zflat=False,
                blender_white_background=True, num_random_rays=0, num_variations=1, seed=0,
                format=fmt)
    base.update(kw)
    return argparse.Namespace(**base)


@pytest.mark.parametrize("kind", ["blender", "llff"])
def test_cache_dataset_writes_what_the_jax_script_writes(blender, tmp_path, kind):
    basedir = blender[0] if kind == "blender" else write_llff(tmp_path / "llff")
    theirs_dir = basedir if kind == "blender" else str(shutil.copytree(basedir,
                                                                       tmp_path / "llff2"))
    for fmt in ("binary", "npz", "reference"):
        kw = {"num_random_rays": 50} if fmt == "reference" else {}
        ours = cache_dataset.cache_nerf_dataset(_args(basedir, str(tmp_path / "ours" / fmt),
                                                      fmt, kind, **kw))
        theirs = jax_cache.cache_nerf_dataset(_args(theirs_dir, str(tmp_path / "jax" / fmt),
                                                    fmt, kind, **kw))
        if fmt == "binary":
            a, b = open(ours, "rb").read(), open(theirs, "rb").read()
            if kind == "llff":
                assert a == b
            else:   # targets come from the float32 half_res resize: within its tolerance
                header = 56
                n = (len(a) - header) // 3
                assert len(a) == len(b) and a[:header + 2 * n] == b[:header + 2 * n]
                np.testing.assert_allclose(np.frombuffer(a[header + 2 * n:], np.float32),
                                           np.frombuffer(b[header + 2 * n:], np.float32),
                                           rtol=0, atol=3e-6)
        elif fmt == "npz":
            with np.load(ours) as x, np.load(theirs) as y:
                assert sorted(x.files) == sorted(y.files)
                assert bytes(x["meta_json"]) == bytes(y["meta_json"])
                for k in x.files:
                    np.testing.assert_allclose(x[k], y[k], rtol=0,
                                               atol=0 if kind == "llff" else 3e-6)
        else:
            for split in ("train", "val"):
                names = sorted(os.listdir(os.path.join(ours, split)))
                assert names == sorted(os.listdir(os.path.join(theirs, split)))
                for name in names:
                    x = torch.load(os.path.join(ours, split, name), weights_only=True)
                    y = torch.load(os.path.join(theirs, split, name), weights_only=True)
                    assert sorted(x) == sorted(y)
                    for k in x:
                        if isinstance(x[k], torch.Tensor):
                            torch.testing.assert_close(x[k], y[k], rtol=0,
                                                       atol=0 if kind == "llff" else 3e-6)
                        else:
                            assert x[k] == y[k]


def test_training_from_the_nrc_draws_the_live_store(blender, tmp_path):
    basedir, _ = blender
    cfg_path = os.path.join(REPO, "configs", "lego_fused.yml")
    live = train_nerf.main(["--config", cfg_path, "--device", "cpu", "--overrides",
                            *map(str, _lego(basedir, str(tmp_path / "live")))])
    path = cache_dataset.main(["--datapath", basedir, "--type", "blender", "--savedir",
                               str(tmp_path / "cache"), "--half-res",
                               "--blender-white-background", "--format", "binary"])
    assert path.endswith("rays.nrc")
    overrides = _lego(basedir, str(tmp_path / "cached"), ["dataset.cachedir",
                                                         str(tmp_path / "cache")])
    cfg = load_config(cfg_path, overrides)
    live_rays = train_nerf.load_dataset(load_config(cfg_path, _lego(basedir, "x")))["rays"]
    cached = train_nerf.load_dataset(cfg)
    assert cached["store_builder"] == "cache" and cached["near"] == 2.0
    for a, b in zip(cached["rays"], live_rays):
        np.testing.assert_array_equal(a, b)
    run = train_nerf.train(cfg, device="cpu")
    assert run.losses == live.losses and run.val_psnrs == []


def test_chip_smoke_fern_config_is_fern_yml():
    """``chip_smoke.fern_config()`` (the card has no YAML reader) holds
    ``configs/fern.yml``'s values."""
    import chip_smoke

    want = load_config(os.path.join(REPO, "configs", "fern.yml"))
    got = chip_smoke.fern_config()
    for section in ("experiment", "dataset", "models", "optimizer", "scheduler"):
        assert got[section].to_dict() == want[section].to_dict(), section
    assert got.nerf.train.to_dict() == want.nerf.train.to_dict()
    assert got.nerf.validation.to_dict() == want.nerf.validation.to_dict()
    assert got.nerf.use_viewdirs == want.nerf.use_viewdirs

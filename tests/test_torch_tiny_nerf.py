"""nerf_tpu_torch.tiny_nerf against the JAX demo.

- One training step of the demo's protocol (VeryTinyNeRFModel, coarse
  only, no view directions, uniform depths, Adam 5e-3) on the same weights
  and the same numpy ray batch: the loss to rtol 1e-5 and the parameters to
  atol 5e-6 (1e-3 of the lr: Adam divides each gradient element by its own
  magnitude, so an element near 0 carries its float32 rounding into its
  step); the held-out render to 1e-5.
- The CLI on the CPU, synthetic scene and ``.npz``: the held-out PSNR
  rises, and the logs, renders and the PSNR curve are written.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tiny_nerf as jtiny
from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine import train as jtrain
from nerf_tpu.engine.checkpoint import to_torch_state_dict
from nerf_tpu.models import VeryTinyNeRFModel as JaxVeryTiny
from nerf_tpu_torch import tiny_nerf
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.models import VeryTinyNeRFModel
from nerf_tpu_torch.ops import get_ray_bundle as t_ray_bundle
from nerf_tpu.ops import get_ray_bundle as j_ray_bundle

torch.set_num_threads(1)


def test_one_step_matches_jax():
    jmodel = JaxVeryTiny(num_encoding_functions=6, use_viewdirs=False)
    opt = jtrain.make_optimizer("adam", 5e-3)
    jstate = jtrain.create_train_state(jmodel, None, opt, jax.random.PRNGKey(0))
    settings = dict(num_coarse=32, num_fine=0, perturb=False, use_viewdirs=False,
                    white_background=False, near=2.0, far=6.0, num_encoding_fn_xyz=6,
                    include_input_xyz=True, chunksize=64)
    assert tiny_nerf.tiny_settings(2.0, 6.0, 64) == trend.RenderSettings(**settings)
    jstep = jtrain.make_train_step(jmodel, None, jrend.RenderSettings(**settings), opt,
                                   jit=False)
    tmodel = load_jax_params(VeryTinyNeRFModel(num_encoding_functions=6, use_viewdirs=False),
                             jax.tree.map(np.asarray, jstate.params_coarse))
    tstate = ttrain.create_train_state(tmodel, None, ttrain.make_optimizer("adam", 5e-3))
    tstep = ttrain.make_train_step(tmodel, None, tiny_nerf.tiny_settings(2.0, 6.0, 64))
    rng = np.random.default_rng(0)
    ro = (rng.uniform(-0.3, 0.3, (64, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = (rng.normal(size=(64, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    tgt = rng.uniform(0, 1, (64, 3)).astype(np.float32)
    jstate, jm = jstep(jstate, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt),
                       jax.random.PRNGKey(1))
    tstate, tm = tstep(tstate, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tgt))
    np.testing.assert_allclose(float(tm.loss), float(jm.loss), rtol=1e-5)
    np.testing.assert_allclose(float(tm.psnr), float(jm.psnr), rtol=1e-5)
    want = to_torch_state_dict(jax.tree.map(np.asarray, jstate.params_coarse))
    for name, p in tmodel.state_dict().items():
        np.testing.assert_allclose(p.numpy(), want[name], rtol=0, atol=5e-6, err_msg=name)
    # The held-out render of the demo's image renderer.
    pose = np.eye(4, dtype=np.float32)[:3]
    pose[2, 3] = 4.0
    jimg = jrend.make_image_render_fn(jmodel, None, jrend.RenderSettings(**settings))(
        jstate.params_coarse, None, *j_ray_bundle(6, 5, 7.0, jnp.asarray(pose)))["rgb_coarse"]
    timg = trend.make_image_render_fn(tmodel, None, tiny_nerf.tiny_settings(2.0, 6.0, 64))(
        *t_ray_bundle(6, 5, 7.0, torch.from_numpy(pose)))["rgb_coarse"]
    np.testing.assert_allclose(timg.numpy(), np.asarray(jimg), rtol=0, atol=1e-5)


def test_npz_layout_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    path = tmp_path / "tiny.npz"
    np.savez(path, images=rng.uniform(0, 1, (4, 10, 12, 3)).astype(np.float64),
             poses=rng.normal(size=(4, 4, 4)), focal=np.float64(13.5))
    got, want = tiny_nerf.load_npz_dataset(str(path)), jtiny.load_npz_dataset(str(path))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("source", ["synthetic", "npz"])
def test_cli_trains_on_the_cpu(source, tmp_path):
    args = ["--iters", "40", "--size", "16", "--display-every", "20", "--logdir",
            str(tmp_path / "logs"), "--device", "cpu"]
    if source == "npz":
        from nerf_tpu_torch.data import make_synthetic_dataset

        ds = make_synthetic_dataset(num_views=5, height=12, width=12)
        np.savez(tmp_path / "t.npz", images=ds.images, poses=ds.poses, focal=ds.hwf[2])
        args += ["--npz", str(tmp_path / "t.npz")]
    result = tiny_nerf.main(args)
    psnrs = [p for _, p in result.val_psnrs]
    assert [i for i, _ in result.val_psnrs] == [0, 20, 39]
    assert np.all(np.isfinite(psnrs)) and psnrs[-1] > psnrs[0] + 3.0
    logs = os.listdir(tmp_path / "logs")
    assert {"metrics.jsonl", "psnr_curve.png", "images"} <= set(logs)
    assert len(os.listdir(tmp_path / "logs" / "images")) == 3

"""Training resumes across packages through native ``.ntc`` checkpoints.

- A ``.ntc`` the JAX package's own ``save_checkpoint`` writes from a JAX
  train state (params and the ``optax.flatten`` Adam state, as the JAX
  trainer saves it) resumes in the port: weights, moments raveled back into
  torch's per-parameter (out, in) layout, Adam's count and the schedule's
  position. The next two steps' losses track JAX's to rtol 2e-3, as
  ``tests/test_torch_train.py`` holds ``.ckpt`` resumes.
- The port's ``.ntc`` reads back with ``nerf_tpu.engine.checkpoint.
  load_checkpoint``; its optax state has the leaves of a JAX template of the
  same optimizer (the JAX trainer's resume check), for every layout the
  port's optimizers give, and JAX continues from it on the same track.
- Through ``train_nerf.train`` on the CPU: k steps, resume from the
  ``.ntc`` it wrote, continue; the losses are bitwise those of the
  uninterrupted run. A ``.ntc`` of another optimizer layout restores the
  weights and starts Adam fresh, as the JAX trainer does.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine import train as jtrain
from nerf_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from nerf_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch import train_nerf
from nerf_tpu_torch.config import load_config, model_from_config
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import (
    latest_checkpoint,
    load_train_checkpoint,
    ntc_train_state,
    save_checkpoint,
)
from nerf_tpu_torch.models import FlexibleNeRFModel

torch.set_num_threads(1)
ENC = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
NARROW = dict(num_layers=2, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=3,
              num_encoding_fn_dir=2)


def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32) + np.float32([0.0, 0.0, 4.0])
    rd = (rng.normal(size=(n, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    return ro, rd, rng.uniform(0, 1, (n, 3)).astype(np.float32)


def _settings(enc):
    kw = dict(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
              white_background=True, near=2.0, far=6.0, **{k: enc[k] for k in
                                                           ("num_encoding_fn_xyz",
                                                            "num_encoding_fn_dir")})
    return jrend.RenderSettings(**kw), trend.RenderSettings(**kw)


def _jax_steps(jmodel, state, js, batches, opt):
    step = jtrain.make_train_step(jmodel, jmodel, js, opt, jit=False)
    losses = []
    for i, (ro, rd, tgt) in enumerate(batches):
        state, m = step(state, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt),
                        jax.random.PRNGKey(i))
        losses.append(float(m.loss))
    return state, losses


def _port_steps(state, ts, batches):
    step = ttrain.make_train_step(state.model_coarse, state.model_fine, ts)
    losses = []
    for ro, rd, tgt in batches:
        state, m = step(state, *(torch.from_numpy(a) for a in (ro, rd, tgt)))
        losses.append(float(m.loss))
    return state, losses


def _jax_ntc(path, state, loss):
    """What the JAX trainer saves (root train_nerf.py, ``save_checkpoint``)."""
    jax_save_checkpoint(path, {"step": int(state.step), "params_coarse": state.params_coarse,
                               "params_fine": state.params_fine, "opt_state": state.opt_state,
                               "loss": loss, "psnr": 0.0})


def test_resume_from_a_jax_ntc(tmp_path):
    jmodel = JaxFlexible(**ENC)
    opt = jtrain.make_optimizer("Adam", 5e-3, 250, 0.1)
    jstate = jtrain.create_train_state(jmodel, jmodel, opt, jax.random.PRNGKey(0))
    js, ts = _settings(ENC)
    batches = [_batch(20 + i) for i in range(4)]
    jstate, first = _jax_steps(jmodel, jstate, js, batches[:2], opt)
    path = str(tmp_path / "checkpoint00002.ntc")
    _jax_ntc(path, jstate, first[-1])
    _, want = _jax_steps(jmodel, jstate, js, batches[2:], opt)

    spec = ttrain.make_optimizer("Adam", 5e-3, 250, 0.1)
    state = ttrain.create_train_state(FlexibleNeRFModel(**ENC), FlexibleNeRFModel(**ENC), spec)
    info = load_train_checkpoint(path, state.model_coarse, state.model_fine, state.optimizer,
                                 spec)
    assert info == {"step": 2, "count": 2, "moments": True}
    steps = [s["step"] for s in state.optimizer.state.values()]
    assert len(steps) == 32 and len({id(s) for s in steps}) == 32
    assert all(float(s) == 2.0 for s in steps)
    # The moments, raveled back: layers_xyz.0's weight is (out, in) here.
    mu = jax.tree.leaves(jstate.opt_state)[1]
    w = state.model_coarse.layers_xyz[0].weight
    assert tuple(state.optimizer.state[w]["exp_avg"].shape) == tuple(w.shape)
    assert float(state.optimizer.state[w]["exp_avg"].abs().sum()) > 0
    assert mu.shape == (sum(p.numel() for p in state.params),)
    state.step = info["step"]
    state.scheduler = spec.make_scheduler(state.optimizer, info["count"])
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jtrain.exponential_lr_schedule(5e-3, 250, 0.1)(2)), rel=1e-6)
    state, got = _port_steps(state, ts, batches[2:])
    np.testing.assert_allclose(got, want, rtol=2e-3)


def _jax_opt(name, clip, decay):
    sched = (250, 0.1) if decay else (None, None)
    return (jtrain.make_optimizer(name, 5e-3, *sched, grad_clip_norm=clip),
            ttrain.make_optimizer(name, 5e-3, *sched, grad_clip_norm=clip))


@pytest.mark.parametrize("name,clip,decay", [("Adam", None, True), ("Adam", None, False),
                                             ("Adam", 1.0, True), ("AdamW", None, True),
                                             ("SGD", None, True)],
                         ids=["adam", "adam-const", "adam-clip", "adamw", "sgd"])
def test_port_ntc_resumes_in_jax(tmp_path, name, clip, decay):
    jopt, spec = _jax_opt(name, clip, decay)
    jmodel = JaxFlexible(**NARROW)
    template = jtrain.create_train_state(jmodel, jmodel, jopt, jax.random.PRNGKey(1))
    js, ts = _settings(NARROW)
    mc, mf = FlexibleNeRFModel(**NARROW), FlexibleNeRFModel(**NARROW)
    for i, m in enumerate((mc, mf)):
        m.reset_parameters(torch.Generator().manual_seed(i))
    state = ttrain.create_train_state(mc, mf, spec)
    batches = [_batch(40 + i) for i in range(4)]
    state, first = _port_steps(state, ts, batches[:2])
    path = str(tmp_path / "checkpoint00002.ntc")
    save_checkpoint(path, ntc_train_state(2, mc, mf, state.optimizer, spec,
                                          state.scheduler.last_epoch, first[-1], 20.0))
    state, want = _port_steps(state, ts, batches[2:])

    restored = jax_load_checkpoint(path)
    assert int(restored["step"]) == 2 and float(restored["loss"]) == first[-1]
    leaves = jax.tree.leaves(restored["opt_state"])
    ref = jax.tree.leaves(template.opt_state)
    assert [(np.shape(a), np.asarray(a).dtype) for a in leaves] == [
        (b.shape, b.dtype) for b in ref]
    opt_state = jax.tree.unflatten(jax.tree.structure(template.opt_state),
                                   [jnp.asarray(x) for x in leaves])
    assert int(leaves[0]) == 2           # Adam's count, or SGD's schedule's
    jstate = jtrain.TrainState(jnp.asarray(2, jnp.int32),
                               jax.tree.map(jnp.asarray, restored["params_coarse"]),
                               jax.tree.map(jnp.asarray, restored["params_fine"]), opt_state)
    _, got = _jax_steps(jmodel, jstate, js, batches[2:], jopt)
    np.testing.assert_allclose(got, want, rtol=2e-3)


TINY_PY = """
_model = {{"type": "FlexibleNeRFModel", "num_layers": 2, "hidden_size": 16,
           "num_encoding_fn_xyz": 4, "num_encoding_fn_dir": 2}}
cfg = {{
    "experiment": {{"id": "tiny", "logdir": {logdir!r}, "randomseed": 5, "train_iters": 6,
                    "print_every": 2, "validate_every": 100, "save_every": 2}},
    "dataset": {{"type": "synthetic", "num_views": 2, "image_size": 8}},
    "models": {{"coarse": dict(_model), "fine": dict(_model)}},
    "optimizer": {{"type": "Adam", "lr": 5e-3}},
    "scheduler": {{"lr_decay": 250, "lr_decay_factor": 0.1}},
    "nerf": {{
        "train": {{"num_random_rays": 16, "num_coarse": 8, "num_fine": 8, "perturb": True,
                   "radiance_field_noise_std": 0.2, "white_background": True}},
        "validation": {{"num_coarse": 8, "num_fine": 8, "chunksize": 64,
                        "white_background": True}},
    }},
}}
"""


@pytest.fixture(scope="module")
def tiny_cfg(tmp_path_factory):
    d = tmp_path_factory.mktemp("ntc_cli")
    path = d / "tiny.py"
    path.write_text(TINY_PY.format(logdir=str(d / "logs")))
    return str(path), d


def test_trainer_round_trip_through_its_ntc_is_bitwise(tiny_cfg):
    cfg_path, d = tiny_cfg
    whole = train_nerf.train(load_config(cfg_path), logdir=str(d / "whole"), device="cpu")
    part = train_nerf.train(load_config(cfg_path, ["experiment.train_iters", 4]),
                            logdir=str(d / "part"), device="cpu")
    assert sorted(f for f in os.listdir(d / "part") if f.startswith("checkpoint")) == [
        "checkpoint00002.ckpt", "checkpoint00002.ntc", "checkpoint00004.ckpt",
        "checkpoint00004.ntc"]
    assert latest_checkpoint(str(d / "part")).endswith("checkpoint00004.ntc")
    rest = train_nerf.main(["--config", cfg_path, "--device", "cpu", "--load-checkpoint",
                            str(d / "part" / "checkpoint00004.ntc"), "--overrides",
                            "experiment.id", "rest"])
    assert rest.start_step == 4 and len(rest.losses) == 2
    assert part.losses == whole.losses[:4]
    assert rest.losses == whole.losses[4:]
    for name in ("checkpoint00006.ntc",):
        a = jax_load_checkpoint(os.path.join(whole.logdir, name))
        b = jax_load_checkpoint(os.path.join(rest.logdir, name))
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_ntc_of_another_layout_starts_adam_fresh(tiny_cfg, capsys):
    cfg_path, d = tiny_cfg
    cfg = load_config(cfg_path)
    mc, mf = (model_from_config(cfg.models[which]) for which in ("coarse", "fine"))
    spec = ttrain.make_optimizer("Adam", 5e-3)                # no schedule: one leaf fewer
    state = ttrain.create_train_state(mc, mf, spec)
    path = str(d / "const.ntc")
    save_checkpoint(path, ntc_train_state(3, mc, mf, state.optimizer, spec, 3, 0.5, 9.0))
    run = train_nerf.train(load_config(cfg_path, ["experiment.train_iters", 4]),
                           logdir=str(d / "fresh"), device="cpu", load_checkpoint=path)
    out = capsys.readouterr().out
    assert "checkpoint optimizer layout differs; starting Adam fresh" in out
    assert run.start_step == 3 and len(run.losses) == 1
    weights = {k: v for k, v in jax_load_checkpoint(path)["params_coarse"].items()}
    assert set(weights) == {"layer1", "layers_xyz", "fc_feat", "fc_alpha", "layers_dir", "fc_rgb"}

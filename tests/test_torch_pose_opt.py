"""nerf_tpu_torch.engine.pose_opt and ``python -m nerf_tpu_torch.optimize_poses``
against the JAX package.

A narrow Flexible model (2 x 32, 4/2 encoding; JAX ``init`` weights scaled
x3 with a +2 density bias so the images carry pose information) renders its
own targets from known poses. Both packages then get the same weights,
poses, images and the same pixel indices (the JAX keys' draws, computed
here and injected into the port):
- ``twists_to_poses``, ``pose_errors``, ``perturb_poses`` (the JAX draws of
  axes and directions injected), ``align_poses_umeyama``;
- the photometric loss and its gradients in ``xi`` and ``log_focal``;
- one and three Adam steps against optax, one ``joint_update``;
- a refinement on the CPU that recovers perturbed poses (the gate of the
  JAX package's ``tests/test_pose_refinement.py``);
- the CLI's JSON report, key for key against the JAX CLI's.
"""

import dataclasses
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.data.poses import pose_spherical
from nerf_tpu.engine import pose_opt as jpo
from nerf_tpu.engine.checkpoint import save_checkpoint as jax_save_checkpoint
from nerf_tpu.engine.renderer import RenderSettings as JaxSettings
from nerf_tpu.engine.renderer import make_pose_render_fn as jax_pose_render_fn
from nerf_tpu.lie import so3_exp as jax_so3_exp
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch import eval_nerf, optimize_poses
from nerf_tpu_torch.engine import pose_opt as tpo
from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, load_jax_params
from nerf_tpu_torch.engine.renderer import RenderSettings
from nerf_tpu_torch.engine.train import make_optimizer
from nerf_tpu_torch.models import FlexibleNeRFModel

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
H = W = 20
FOCAL = 18.0
RAYS = 24


def _opacified_params(seed):
    params = jax.tree.map(lambda x: np.asarray(x) * 3.0,
                          JaxFlexible(**NARROW).init(jax.random.PRNGKey(seed)))
    params["fc_alpha"]["bias"] = params["fc_alpha"]["bias"] + 2.0
    return params


def _settings(num_fine=12, **kw):
    base = dict(num_coarse=12, num_fine=num_fine, perturb=False, radiance_field_noise_std=0.0,
                white_background=False, near=2.0, far=6.0, use_viewdirs=True,
                num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
    base.update(kw)
    return JaxSettings(**base), RenderSettings(**base)


@pytest.fixture(scope="module")
def scene():
    """The frozen model and its own renders from 3 true poses."""
    jmodel = JaxFlexible(**NARROW)
    params = _opacified_params(3)
    js, ts = _settings()
    true = np.stack([pose_spherical(30.0 + 140.0 * i, -30.0, 4.0)[:3, :4]
                     for i in range(3)]).astype(np.float32)
    render = jax_pose_render_fn(jmodel, jmodel, js, H, W, FOCAL, output="f32")
    images = np.stack([np.asarray(render(params, params, jnp.asarray(p))) for p in true])
    tmodel = load_jax_params(FlexibleNeRFModel(**NARROW), params)
    return dict(jmodel=jmodel, params=params, tmodel=tmodel, js=js, ts=ts, true=true,
                images=images)


def _jax_pixel_indices(key, n, rays):
    """The pixels JAX's ``_sample_pixel_rays`` draws from a loss key."""
    k_pix, _ = jax.random.split(key)
    return np.stack([np.asarray(jax.random.randint(jax.random.fold_in(k_pix, i), (rays,), 0,
                                                   H * W)) for i in range(n)])


def _jax_axes_directions(key, n):
    k_axis, k_dir = jax.random.split(key)
    return (np.asarray(jax.random.normal(k_axis, (n, 3))),
            np.asarray(jax.random.normal(k_dir, (n, 3))))


def _perturbed(scene, seed=7, rot=2.0, trans=0.04):
    axes, dirs = _jax_axes_directions(jax.random.PRNGKey(seed), 3)
    return tpo.perturb_poses(torch.from_numpy(scene["true"]), 0, rot, trans,
                             axes=torch.from_numpy(axes), directions=torch.from_numpy(dirs))


def _close(got, want, tol):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def test_twists_poses_errors_and_perturbation_match_jax(scene):
    true = scene["true"]
    xi = (np.random.default_rng(0).standard_normal((3, 6)) * 0.1).astype(np.float32)
    _close(tpo.twists_to_poses(torch.from_numpy(xi), torch.from_numpy(true)),
           jpo.twists_to_poses(jnp.asarray(xi), jnp.asarray(true)), 2e-6)
    _close(tpo.twists_to_poses(torch.zeros(3, 6), torch.from_numpy(true)), true, 0)
    _close(tpo.as_homogeneous(torch.from_numpy(true)), jpo.as_homogeneous(jnp.asarray(true)), 0)

    key = jax.random.PRNGKey(0)
    want = jpo.perturb_poses(jnp.asarray(true), key, rot_deg=2.0, trans=0.05)
    axes, dirs = _jax_axes_directions(key, 3)
    got = tpo.perturb_poses(torch.from_numpy(true), 0, 2.0, 0.05, axes=torch.from_numpy(axes),
                            directions=torch.from_numpy(dirs))
    _close(got, want, 2e-6)
    for name, value in tpo.pose_errors(got, torch.from_numpy(true)).items():
        _close(value, jpo.pose_errors(want, jnp.asarray(true))[name], 2e-4)
        _close(value, {"rot_deg": 2.0, "trans": 0.05}[name], 2e-3 if name == "rot_deg" else 1e-5)
    drawn = tpo.perturb_poses(torch.from_numpy(true), 5, 2.0, 0.05)
    assert torch.equal(drawn, tpo.perturb_poses(torch.from_numpy(true), 5, 2.0, 0.05))
    _close(tpo.pose_errors(drawn, torch.from_numpy(true))["rot_deg"], 2.0, 2e-3)


def test_align_poses_umeyama_matches_jax(scene):
    poses = np.stack([pose_spherical(60.0 * i, -25.0, 4.0)[:3, :4]
                      for i in range(6)]).astype(np.float32)
    g_R = np.asarray(jax_so3_exp(jnp.asarray([0.3, -0.2, 0.5])))
    s, t = 1.3, np.asarray([0.4, -0.1, 0.25], np.float32)
    moved = np.concatenate([g_R @ poses[:, :3, :3],
                            (s * (poses[:, :3, 3] @ g_R.T) + t)[..., None]], axis=-1)
    for with_scale in (True, False):
        want = jpo.align_poses_umeyama(jnp.asarray(moved), jnp.asarray(poses), with_scale)
        got = tpo.align_poses_umeyama(torch.from_numpy(moved), torch.from_numpy(poses),
                                      with_scale)
        _close(got, want, 1e-5)
    aligned = tpo.align_poses_umeyama(torch.from_numpy(moved), torch.from_numpy(poses))
    err = tpo.pose_errors(aligned, torch.from_numpy(poses))
    _close(err["rot_deg"], np.zeros(6), 1e-3)
    _close(err["trans"], np.zeros(6), 1e-5)


@pytest.mark.parametrize("refine_focal", [False, True], ids=["poses", "poses+focal"])
def test_photometric_loss_and_gradients_match_jax(scene, refine_focal):
    noisy = _perturbed(scene)
    base44 = tpo.as_homogeneous(noisy)
    xi = (np.random.default_rng(1).standard_normal((3, 6)) * 0.01).astype(np.float32)
    opt = {"xi": jnp.asarray(xi), "log_focal": jnp.asarray(0.02, jnp.float32)}
    key = jax.random.PRNGKey(4)
    jloss = jpo.make_photometric_loss_fn(scene["jmodel"], scene["jmodel"], scene["js"], H, W,
                                         FOCAL, RAYS, refine_focal=refine_focal)
    want_loss, want_g = jax.jit(jax.value_and_grad(jloss))(opt, jnp.asarray(base44.numpy()),
                                                  jnp.asarray(scene["images"]),
                                                  scene["params"], scene["params"], key)
    tloss = tpo.make_photometric_loss_fn(scene["tmodel"], scene["tmodel"], scene["ts"], H, W,
                                         FOCAL, RAYS, refine_focal=refine_focal)
    params = {"xi": torch.tensor(xi, requires_grad=True),
              "log_focal": torch.tensor(0.02, requires_grad=True)}
    loss = tloss(params, base44, torch.from_numpy(scene["images"]), 0,
                 pixel_indices=torch.from_numpy(_jax_pixel_indices(key, 3, RAYS)))
    g_xi, g_f = torch.autograd.grad(loss, [params["xi"], params["log_focal"]],
                                    allow_unused=True)
    assert float(want_loss) > 1e-3
    _close(loss, want_loss, 1e-5)
    scale = float(np.abs(np.asarray(want_g["xi"])).max())
    np.testing.assert_allclose(g_xi.numpy() / scale, np.asarray(want_g["xi"]) / scale,
                               rtol=0, atol=1e-4)
    if refine_focal:
        _close(g_f, want_g["log_focal"], 1e-4 * max(1.0, abs(float(want_g["log_focal"]))))
    else:
        assert g_f is None and float(want_g["log_focal"]) == 0.0


def test_adam_steps_match_optax(scene):
    """One and three steps of ``make_pose_opt_step`` (the port's Adam on
    ``xi`` and ``log_focal``) against JAX's step with ``optax.adam``, each
    step on the pixels the JAX key draws; ``log_focal`` stays exactly 0."""
    noisy = _perturbed(scene, seed=2, rot=1.0, trans=0.02)
    base44 = tpo.as_homogeneous(noisy)
    images = scene["images"]
    jstep = jax.jit(jpo.make_pose_opt_step(scene["jmodel"], scene["jmodel"], scene["js"], H, W,
                                           FOCAL, RAYS, optax.adam(1e-3)))
    jstate = jpo.init_pose_opt_state(3, optax.adam(1e-3))
    tstep = tpo.make_pose_opt_step(scene["tmodel"], scene["tmodel"], scene["ts"], H, W, FOCAL,
                                   RAYS)
    tstate = tpo.init_pose_opt_state(3, tpo.pose_optimizer(1e-3))
    for i in range(3):
        key = jax.random.PRNGKey(10 + i)
        jstate, jl = jstep(jstate, jnp.asarray(base44.numpy()), jnp.asarray(images),
                           scene["params"], scene["params"], key)
        tstate, tl = tstep(tstate, base44, torch.from_numpy(images), 0,
                           pixel_indices=torch.from_numpy(_jax_pixel_indices(key, 3, RAYS)))
        _close(tl, jl, 1e-5)
        _close(tstate.xi, jstate.xi, 1e-6)
        if i == 0:
            # Adam's first step moves every component by lr * sign(g).
            _close(tstate.xi.abs(), np.full((3, 6), 1e-3), 1e-6)
    assert float(tstate.log_focal) == 0.0 == float(jstate.log_focal)


def test_pose_optimizer_decays_like_optax():
    init = tpo.pose_optimizer(1e-3, iters=10, lr_final=1e-5)
    opt, sched = init([torch.zeros(2, requires_grad=True)])
    schedule = optax.exponential_decay(1e-3, 10, 1e-2)
    for t in range(12):
        np.testing.assert_allclose(opt.param_groups[0]["lr"], float(schedule(t)), rtol=1e-6)
        sched.step()
    opt, _ = tpo.pose_optimizer(2e-3)([torch.zeros(2, requires_grad=True)])
    assert opt.param_groups[0]["lr"] == 2e-3


def test_joint_update_matches_jax(scene):
    """One joint scene + camera update: the NeRF Adam (with the config's
    global-norm clipping) and the camera Adam on one loss, camera 0
    anchored."""
    noisy = _perturbed(scene, seed=3, rot=1.0, trans=0.02)
    base44 = tpo.as_homogeneous(noisy)
    images = scene["images"]
    js, ts = _settings(num_fine=0)
    key = jax.random.PRNGKey(5)
    jnerf = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(5e-3))
    jpose = optax.adam(1e-3)
    pc = scene["params"]
    jstate = jpo.JointTrainState(pc, None, jnerf.init({"coarse": pc}),
                                 jpo.init_pose_opt_state(3, jpose))
    jloss = jpo.make_photometric_loss_fn(scene["jmodel"], None, js, H, W, FOCAL, RAYS)

    def full_loss(opt_params, nerf_params):
        return jloss(opt_params, jnp.asarray(base44.numpy()), jnp.asarray(images),
                     nerf_params["coarse"], None, key)

    jstate, jl = jax.jit(lambda st: jpo.joint_update(st, full_loss, jnerf, jpose,
                                                     anchor_first=True))(jstate)

    tmodel = load_jax_params(FlexibleNeRFModel(**NARROW), pc)
    tstate = tpo.joint_train_state(tmodel, None, 3, make_optimizer("adam", 5e-3,
                                                                    grad_clip_norm=0.5),
                                   tpo.pose_optimizer(1e-3))
    tloss = tpo.make_photometric_loss_fn(tmodel, None, ts, H, W, FOCAL, RAYS)
    pixels = torch.from_numpy(_jax_pixel_indices(key, 3, RAYS))
    tstate, tl = tpo.joint_update(
        tstate, lambda op: tloss(op, base44, torch.from_numpy(images), 0, pixel_indices=pixels),
        anchor_first=True)
    _close(tl, jl, 1e-5)
    _close(tstate.pose.xi, jstate.pose.xi, 1e-6)
    assert float(tstate.pose.xi[0].abs().max()) == 0.0
    got = convert_torch_state_dict(tmodel.state_dict())
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jstate.params_coarse)):
        _close(a, b, 2e-6)
    assert max(float(np.abs(a - b).max())
               for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(pc))) > 1e-3


def test_refine_focal_is_refused_for_ndc(scene):
    _, ts = _settings()
    with pytest.raises(ValueError, match="NDC"):
        tpo.make_photometric_loss_fn(scene["tmodel"], None, dataclasses.replace(ts, use_ndc=True),
                                     H, W, FOCAL, RAYS, refine_focal=True)


def test_render_key_fold_decorrelates_stochastic_loss(scene):
    _, ts = _settings(num_fine=0)
    noisy_ts = dataclasses.replace(ts, radiance_field_noise_std=0.5, perturb=True)
    state = tpo.init_pose_opt_state(3, tpo.pose_optimizer(1e-3))
    base44 = tpo.as_homogeneous(torch.from_numpy(scene["true"]))
    images = torch.from_numpy(scene["images"])
    with torch.no_grad():
        for settings, differ in ((noisy_ts, True), (ts, False)):
            loss = tpo.make_photometric_loss_fn(scene["tmodel"], None, settings, H, W, FOCAL, 32)
            l0 = float(loss(state.opt_params, base44, images, 3, render_key_fold=0))
            l1 = float(loss(state.opt_params, base44, images, 3, render_key_fold=1))
            assert (l0 != l1) == differ


def test_pixel_streams_are_keyed_by_global_image_index(scene):
    poses = torch.from_numpy(scene["true"])
    images = torch.from_numpy(scene["images"])
    full = tpo._sample_pixel_rays(poses, images, 9, H, W, FOCAL, RAYS)
    tail = tpo._sample_pixel_rays(poses[1:], images[1:], 9, H, W, FOCAL, RAYS,
                                  image_index_offset=1)
    for a, b in zip(full, tail):
        assert torch.equal(a[RAYS:], b)


def test_refinement_recovers_perturbed_poses(scene):
    """Perturb the cameras by 2 degrees / 0.04 and recover them through the
    frozen renderer: the JAX test's gate (rotation error < 0.6 x, the
    translation error falls)."""
    noisy = _perturbed(scene, seed=7)
    base44 = tpo.as_homogeneous(noisy)
    state = tpo.init_pose_opt_state(3, tpo.pose_optimizer(3e-3))
    loop = tpo.make_pose_opt_loop(scene["tmodel"], scene["tmodel"], scene["ts"], H, W, FOCAL, 48,
                                  steps_per_loop=40)
    images = torch.from_numpy(scene["images"])
    for i in range(4):
        state, losses = loop(state, base44, images, i)
        assert losses.shape == (40,) and torch.isfinite(losses).all()
    true = torch.from_numpy(scene["true"])
    before = tpo.pose_errors(noisy, true)
    with torch.no_grad():
        after = tpo.pose_errors(tpo.twists_to_poses(state.xi, base44), true)
    assert float(after["rot_deg"].mean()) < 0.6 * float(before["rot_deg"].mean())
    assert float(after["trans"].mean()) < float(before["trans"].mean())


# ---------------------------------------------------------------------------
# The CLI against the JAX CLI
# ---------------------------------------------------------------------------

CLI_YAML = """
experiment:
  randomseed: 0
dataset:
  type: synthetic
  num_views: 3
  image_size: 12
  no_ndc: True
  near: 2
  far: 6
models:
  coarse:
    type: FlexibleNeRFModel
    num_layers: 2
    hidden_size: 32
    num_encoding_fn_xyz: 4
    num_encoding_fn_dir: 2
  fine:
    type: FlexibleNeRFModel
    num_layers: 2
    hidden_size: 32
    num_encoding_fn_xyz: 4
    num_encoding_fn_dir: 2
nerf:
  train:
    num_coarse: 8
    num_fine: 8
    white_background: True
    radiance_field_noise_std: 0.2
  validation:
    chunksize: 64
    num_coarse: 8
    num_fine: 8
    white_background: True
"""


@pytest.fixture(scope="module")
def cli(tmp_path_factory):
    d = tmp_path_factory.mktemp("poses")
    cfg = d / "tiny.yml"
    cfg.write_text(CLI_YAML)
    ckpt = str(d / "tiny.ntc")
    jax_save_checkpoint(ckpt, {"step": np.asarray(10), "params_coarse": _opacified_params(0),
                               "params_fine": _opacified_params(1)})
    return str(cfg), ckpt, d


def _jax_cli_report(argv, monkeypatch, capsys):
    monkeypatch.syspath_prepend(REPO)
    module = importlib.import_module("optimize_poses")
    monkeypatch.setattr(sys, "argv", ["optimize_poses.py", *argv])
    capsys.readouterr()
    module.main()
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_report_has_the_jax_keys(cli, monkeypatch, capsys):
    cfg, ckpt, d = cli
    argv = ["--config", cfg, "--checkpoint", ckpt, "--perturb-rot-deg", "2",
            "--perturb-trans", "0.05", "--iters", "4", "--rays-per-image", "16",
            "--steps-per-loop", "2", "--refine-focal", "--perturb-focal", "1.05",
            "--lr-final", "1e-4", "--max-images", "2"]
    want = _jax_cli_report(argv, monkeypatch, capsys)
    got = optimize_poses.main([*argv, "--device", "cpu", "--save-poses", str(d / "p.npz")])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert printed == got
    assert set(got) == set(want) | {"saved"}
    assert got["num_poses"] == 2 and got["iters"] == 4
    np.testing.assert_allclose(got["initial_rot_deg_mean"], 2.0, atol=2e-3)
    np.testing.assert_allclose(got["initial_trans_mean"], 0.05, atol=1e-5)
    np.testing.assert_allclose(got["initial_focal"], want["initial_focal"], rtol=1e-6)
    assert np.isfinite(got["final_loss"]) and got["focal_error_pct"] > 0
    saved = np.load(d / "p.npz")
    assert saved["poses"].shape == (2, 3, 4) and saved["xi"].shape == (2, 6)


def test_cli_joint_train_writes_a_checkpoint_eval_loads(cli, monkeypatch, capsys):
    cfg, ckpt, d = cli
    argv = ["--config", cfg, "--joint-train", "--perturb-rot-deg", "1",
            "--perturb-trans", "0.02", "--iters", "4", "--rays-per-image", "16",
            "--steps-per-loop", "2", "--anneal-iters", "2"]
    want = _jax_cli_report([*argv, "--save-checkpoint", str(d / "jax_joint.ntc")],
                           monkeypatch, capsys)
    out = str(d / "joint.ntc")
    got = optimize_poses.main([*argv, "--device", "cpu", "--save-checkpoint", out])
    assert set(got) == set(want) and got["mode"] == "joint"
    assert np.isfinite(got["final_loss"]) and np.isfinite(got["aligned_rot_deg_mean"])
    result = eval_nerf.render_trajectory(
        __import__("nerf_tpu_torch.config", fromlist=["load_config"]).load_config(cfg), out,
        str(d / "eval"), num_poses=1, renderer="plain", device="cpu")
    assert all(result.finite)


@pytest.mark.parametrize("argv,error", [
    (["--nerf-lr", "1e-3"], "--nerf-lr requires --joint-train"),
    (["--save-checkpoint", "x.ntc"], "--save-checkpoint requires --joint-train"),
    (["--perturb-focal", "1.1"], "--perturb-focal requires --refine-focal"),
    (["--checkpoint", ""], "--checkpoint is required unless --joint-train"),
])
def test_cli_flag_dependencies(cli, capsys, argv, error):
    cfg, ckpt, _ = cli
    with pytest.raises(SystemExit):
        optimize_poses.main(["--config", cfg, "--checkpoint", ckpt, "--device", "cpu", *argv])
    assert error in capsys.readouterr().err


def test_cli_refuses_more_than_one_device(cli):
    """More than one device is ported (tests/test_torch_parallel_cli.py);
    NCCL for ranks on the CPU is refused before any rank starts."""
    cfg, ckpt, _ = cli
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        optimize_poses.main(["--config", cfg, "--checkpoint", ckpt, "--num-devices", "2",
                             "--dist-backend", "nccl", "--device", "cpu"])

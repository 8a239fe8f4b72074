"""nerf_tpu_torch.parallel on two gloo ranks on the CPU against the JAX
package's ``make_parallel_*`` functions on two devices of the virtual mesh
(``tests/conftest.py``), and against the port's own serial paths.

Each fixture spawns two ranks once (``parallel.distributed.run_ranks``, a
60 s collective timeout and a deadline, the ranks killed past it) that run
one of this module's top-level ``_*_rank`` functions and return numpy
results; the tests compare them here. JAX and ``nerf_tpu`` are imported only
inside the functions that compute the JAX references, so a spawned rank
never imports JAX. Models are 2-layer, 16-wide; the same weights (JAX
``init``, carried by ``load_jax_params``) and the same numpy inputs go
through both packages:

- the data-parallel train step (deterministic: no jitter, no sigma noise)
  against JAX's on the same global batch (loss rtol 1e-5, parameters rtol
  1e-4 / atol 1e-6) and against the port's serial step on the union batch;
- five stochastic loop steps: the ranks' parameters bitwise equal, the loss
  falling; the non-finite guard skipping on both ranks for a NaN on one;
- the sharded image, flat and pose renders against JAX's and the serial
  render (1e-6); the sharded sigma grid bitwise the serial one, within 1e-5
  of JAX's;
- the pose and joint refinement loops against JAX's on JAX's pixel draws;
- the data-parallel multi-scene step against the one-device batched step;
- the mesh helpers: ``pad_to_devices``, ``shard_rows`` against JAX's
  ``shard_batch`` layout, the NCCL refusals, and
  ``maybe_initialize_distributed`` with and without ``torchrun``'s
  environment (two ranks joined through it).
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, load_jax_params
from nerf_tpu_torch.engine.renderer import RenderSettings
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.parallel import distributed as tdist
from nerf_tpu_torch.parallel import mesh as tmesh

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(num_layers=2, hidden_size=16, num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
ENC = dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2)
DETERMINISTIC = dict(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                     **ENC)
DEADLINE_S = 240
H, W, FOCAL = 7, 9, 8.0    # 63 pixels: a padded tail over two ranks
POSE_H = POSE_W = 16
RAYS = 16


def _spawn(fn, *args):
    return tdist.run_ranks(fn, 2, *args, backend="gloo", device="cpu", timeout_s=60,
                           deadline_s=DEADLINE_S)


def _model(params):
    return load_jax_params(FlexibleNeRFModel(**NARROW), params)


def _leaves(params) -> list:
    """A params dict's arrays in sorted-key order (``jax.tree.leaves``'s)."""
    if isinstance(params, dict):
        return [x for k in sorted(params) for x in _leaves(params[k])]
    if isinstance(params, (list, tuple)):
        return [x for p in params for x in _leaves(p)]
    return [np.asarray(params)]


def _jax_params(seed, opacify=False):
    import jax

    from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible

    params = jax.tree.map(np.asarray, JaxFlexible(**NARROW).init(jax.random.PRNGKey(seed)))
    if opacify:
        params = jax.tree.map(lambda x: x * 3.0, params)
        params["fc_alpha"]["bias"] = params["fc_alpha"]["bias"] + 2.0
    return params


def _ray_batch(n, seed=0):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    rd = (rng.uniform(-1, 1, (n, 3)) - [0, 0, 1.5]).astype(np.float32)
    return ro, rd, rng.uniform(0, 1, (n, 3)).astype(np.float32)


# --------------------------------------------------------------------------
# Rank bodies (run in spawned processes: no JAX here)


def _train_state(pc, pf, lr):
    from nerf_tpu_torch.engine.train import create_train_state, make_optimizer

    mc, mf = _model(pc), _model(pf)
    return mc, mf, create_train_state(mc, mf, make_optimizer("adam", lr))


def _params_out(mc, mf):
    return {"coarse": convert_torch_state_dict(mc.state_dict()),
            "fine": convert_torch_state_dict(mf.state_dict())}


def _train_rank(pc, pf, batch, store, ms_params):
    from nerf_tpu_torch.engine.train import make_optimizer, make_train_step
    from nerf_tpu_torch.parallel import dp, multiscene

    mesh = tmesh.make_mesh(2, "cpu")
    out = {"rank": mesh.rank}
    settings = RenderSettings(**DETERMINISTIC)
    # One deterministic step on this rank's half of the global batch.
    mc, mf, state = _train_state(pc, pf, 1e-3)
    step = dp.make_parallel_train_step(mc, mf, settings, mesh)
    ro, rd, tgt = tmesh.shard_rows(mesh, *(torch.from_numpy(a) for a in batch))
    state, m = step(state, ro, rd, tgt)
    out["dp"] = dict(loss=float(m.loss), closs=float(m.coarse_loss), floss=float(m.fine_loss),
                     grads=[p.grad.numpy().copy() for p in state.params], **_params_out(mc, mf))
    if mesh.rank == 0:
        # The port's serial step on the union batch.
        mc, mf, state = _train_state(pc, pf, 1e-3)
        state, m = make_train_step(mc, mf, settings)(state, *(torch.from_numpy(a) for a in batch))
        out["serial"] = dict(loss=float(m.loss), grads=[p.grad.numpy().copy()
                                                        for p in state.params],
                             **_params_out(mc, mf))
    # Five stochastic loop steps on this rank's slice of the store.
    noisy = RenderSettings(**{**DETERMINISTIC, "perturb": True, "radiance_field_noise_std": 1.0})
    mc, mf, state = _train_state(pc, pf, 1e-2)
    loop = dp.make_parallel_train_loop(mc, mf, noisy, mesh, 64, 5)
    stores = tmesh.shard_rows(mesh, *(torch.from_numpy(a) for a in store))
    state, m = loop(state, *stores, 7)
    out["loop"] = dict(losses=m.loss.numpy().copy(), step=state.step, **_params_out(mc, mf))
    # The non-finite guard: a NaN target on rank 1 only.
    mc, mf, state = _train_state(pc, pf, 1e-3)
    step = dp.make_parallel_train_step(mc, mf, settings, mesh, nan_guard=True)
    if mesh.rank == 1:
        tgt = tgt.clone()
        tgt[0, 0] = float("nan")
    state, m = step(state, ro, rd, tgt)
    out["guard"] = dict(loss=float(m.loss), step=state.step,
                        count=state.scheduler.last_epoch, **_params_out(mc, mf))
    # The multi-scene step: 2 scenes, this rank's half of each scene's batch.
    spec = make_optimizer("adam", 5e-3)
    ms_settings = RenderSettings(**DETERMINISTIC)
    ms_batch = [torch.from_numpy(a) for a in ms_params["batch"]]
    model = FlexibleNeRFModel(**NARROW)
    ms_state = multiscene.create_multiscene_state(model, model, spec, 3, 2, "cpu")
    ms_step = multiscene.make_parallel_multiscene_train_step(model, model, ms_settings, mesh)
    ms_state, m = ms_step(ms_state, *multiscene.shard_multiscene_stores(mesh, *ms_batch))
    out["ms"] = dict(loss=m.loss.numpy().copy(), closs=m.coarse_loss.numpy().copy(),
                     grads={k: p.grad.numpy().copy() for k, p in ms_state.params.items()},
                     params={k: p.detach().numpy().copy() for k, p in ms_state.params.items()})
    if mesh.rank == 0:
        ms_state = multiscene.create_multiscene_state(model, model, spec, 3, 2, "cpu")
        ms_state, m = multiscene.make_multiscene_train_step(model, model, ms_settings)(
            ms_state, *ms_batch)
        out["ms_serial"] = dict(
            loss=m.loss.numpy().copy(), closs=m.coarse_loss.numpy().copy(),
            grads={k: p.grad.numpy().copy() for k, p in ms_state.params.items()},
            params={k: p.detach().numpy().copy() for k, p in ms_state.params.items()})
    # A few data-parallel multi-scene loop steps, stochastic.
    ms_noisy = RenderSettings(**{**DETERMINISTIC, "perturb": True,
                                 "radiance_field_noise_std": 1.0})
    ms_state = multiscene.create_multiscene_state(model, model, spec, 3, 2, "cpu")
    ms_loop = multiscene.make_parallel_multiscene_train_loop(model, model, ms_noisy, mesh, 16, 3)
    stores = multiscene.shard_multiscene_stores(
        mesh, *(torch.from_numpy(a) for a in ms_params["store"]))
    ms_state, m = ms_loop(ms_state, *stores, 5)
    out["ms_loop"] = dict(losses=m.loss.numpy().copy(), step=ms_state.step,
                          params={k: p.detach().numpy().copy()
                                  for k, p in ms_state.params.items()})
    return out


def _render_rank(pc, pf, rays, pose, grid_args):
    from nerf_tpu_torch.engine import geometry
    from nerf_tpu_torch.engine.renderer import make_image_render_fn, make_pose_render_fn
    from nerf_tpu_torch.parallel import dp
    from nerf_tpu_torch.parallel.geometry import make_parallel_sigma_grid_fn

    mesh = tmesh.make_mesh(2, "cpu")
    mc, mf = _model(pc), _model(pf)
    settings = RenderSettings(**DETERMINISTIC, chunksize=16)
    ro, rd = (torch.from_numpy(a) for a in rays)
    pose = torch.from_numpy(pose)
    out = {"rank": mesh.rank}

    def numpy(maps):
        return None if maps is None else {k: v.numpy().copy() for k, v in maps.items()}

    out["image"] = numpy(dp.make_parallel_image_render_fn(mc, mf, settings, mesh)(ro, rd))
    out["flat"] = numpy(dp.make_parallel_render_fn(mc, mf, settings, mesh)(
        ro.reshape(-1, 3)[:62], rd.reshape(-1, 3)[:62]))
    maps = dp.make_parallel_pose_render_fn(mc, mf, settings, H, W, FOCAL, mesh)(pose)
    out["pose"] = numpy(maps)
    u8 = dp.make_parallel_pose_render_fn(mc, mf, settings, H, W, FOCAL, mesh, output="u8")(pose)
    out["pose_u8"] = None if u8 is None else u8.numpy().copy()
    res, lo, hi, chunk = grid_args
    grid = make_parallel_sigma_grid_fn(mf, settings, res, lo, hi, mesh, chunk)()
    out["grid"] = grid
    if mesh.rank == 0:
        out["serial_image"] = numpy(make_image_render_fn(mc, mf, settings)(ro, rd))
        out["serial_pose"] = numpy(make_pose_render_fn(mc, mf, settings, H, W, FOCAL)(pose))
        out["serial_grid"] = geometry.make_sigma_grid_fn(mf, settings, *grid_args)()
    return out


def _pose_rank(params, base44, images, pixels, joint):
    from nerf_tpu_torch.engine import pose_opt
    from nerf_tpu_torch.engine.train import make_optimizer
    from nerf_tpu_torch.parallel import pose_dp

    mesh = tmesh.make_mesh(2, "cpu")
    settings = RenderSettings(num_coarse=12, num_fine=0, perturb=False,
                              radiance_field_noise_std=0.0, white_background=False,
                              near=2.0, far=6.0, **ENC)
    n = images.shape[0]
    base_l, images_l = tmesh.shard_rows(mesh, torch.from_numpy(base44),
                                        torch.from_numpy(images))
    pix = tmesh.shard_rows(mesh, torch.from_numpy(pixels), axis=1)
    out = {}
    model = _model(params)
    loop = pose_dp.make_parallel_pose_opt_loop(
        model, model, settings, POSE_H, POSE_W, FOCAL * 1.05, RAYS, pixels.shape[0], mesh, n,
        refine_focal=True)
    state = pose_opt.init_pose_opt_state(n, pose_opt.pose_optimizer(3e-3))
    state, losses = loop(state, base_l, images_l, 11, pixel_indices=pix)
    out["pose"] = dict(losses=losses.numpy().copy(), xi=state.xi.detach().numpy().copy(),
                       log_focal=float(state.log_focal))
    mc, mf = _model(joint["coarse"]), _model(joint["fine"])
    state = pose_opt.joint_train_state(mc, mf, n, make_optimizer("adam", 5e-3),
                                       pose_opt.pose_optimizer(3e-3))
    loop = pose_dp.make_parallel_joint_train_loop(mc, mf, settings, POSE_H, POSE_W, FOCAL, RAYS,
                                                  pixels.shape[0], mesh, n)
    state, losses = loop(state, base_l, images_l, 11, pixel_indices=pix)
    out["joint"] = dict(losses=losses.numpy().copy(), xi=state.pose.xi.detach().numpy().copy(),
                        coarse=convert_torch_state_dict(mc.state_dict()))
    if mesh.rank == 0:
        # The port's serial joint loop on all the images and the same pixels.
        mc, mf = _model(joint["coarse"]), _model(joint["fine"])
        state = pose_opt.joint_train_state(mc, mf, n, make_optimizer("adam", 5e-3),
                                           pose_opt.pose_optimizer(3e-3))
        loss_fn = pose_opt.make_photometric_loss_fn(mc, mf, settings, POSE_H, POSE_W, FOCAL,
                                                    RAYS)
        losses = []
        for i in range(pixels.shape[0]):
            state, loss = pose_opt.joint_update(
                state, lambda op: loss_fn(op, torch.from_numpy(base44), torch.from_numpy(images),
                                          0, pixel_indices=torch.from_numpy(pixels[i])), True)
            losses.append(float(loss))
        out["joint_serial"] = dict(losses=np.asarray(losses),
                                   xi=state.pose.xi.detach().numpy().copy(),
                                   coarse=convert_torch_state_dict(mc.state_dict()))
    return out


# --------------------------------------------------------------------------
# Fixtures: one spawn each


@pytest.fixture(scope="module")
def train_run():
    pc, pf = _jax_params(0), _jax_params(1)
    batch = _ray_batch(64)
    store = _ray_batch(256, seed=1)
    rng = np.random.default_rng(4)
    ms = {"batch": [rng.uniform(-1, 1, (2, 16, 3)).astype(np.float32) - [0, 0, 1.5 * (i == 1)]
                    for i in range(2)] + [rng.uniform(0, 1, (2, 16, 3)).astype(np.float32)],
          "store": [rng.uniform(-1, 1, (2, 64, 3)).astype(np.float32) - [0, 0, 1.5 * (i == 1)]
                    for i in range(2)] + [rng.uniform(0, 1, (2, 64, 3)).astype(np.float32)]}
    ms = {k: [np.ascontiguousarray(a, np.float32) for a in v] for k, v in ms.items()}
    return dict(pc=pc, pf=pf, batch=batch, ranks=_spawn(_train_rank, pc, pf, batch, store, ms))


@pytest.fixture(scope="module")
def render_run():
    from nerf_tpu.data.poses import pose_spherical

    pc, pf = _jax_params(0), _jax_params(1)
    pose = np.asarray(pose_spherical(30.0, -30.0, 4.0)[:3, :4], np.float32)
    ro, rd = _jax_rays(pose)
    grid_args = (9, (-1.5,) * 3, (1.5,) * 3, 150)    # 729 points: 5 chunks over 2 ranks
    ranks = _spawn(_render_rank, pc, pf, (ro, rd), pose, grid_args)
    return dict(pc=pc, pf=pf, pose=pose, rays=(ro, rd), grid_args=grid_args, ranks=ranks)


def _jax_rays(pose):
    import jax.numpy as jnp

    from nerf_tpu.ops.rays import get_ray_bundle

    ro, rd = get_ray_bundle(H, W, FOCAL, jnp.asarray(pose))
    return np.asarray(ro, np.float32), np.asarray(rd, np.float32)


@pytest.fixture(scope="module")
def pose_run():
    import jax
    import jax.numpy as jnp

    from nerf_tpu.data.poses import pose_spherical
    from nerf_tpu.engine import pose_opt as jpo
    from nerf_tpu.engine.renderer import RenderSettings as JaxSettings
    from nerf_tpu.engine.renderer import make_pose_render_fn as jax_pose_render_fn
    from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible

    n = 4
    model = JaxFlexible(**NARROW)
    params = _jax_params(3, opacify=True)
    js = JaxSettings(num_coarse=12, num_fine=0, perturb=False, radiance_field_noise_std=0.0,
                     white_background=False, near=2.0, far=6.0, **ENC)
    true = jnp.stack([jnp.asarray(pose_spherical(90.0 * i, -30.0, 4.0)[:3, :4], jnp.float32)
                      for i in range(n)])
    render = jax_pose_render_fn(model, model, js, POSE_H, POSE_W, FOCAL, output="f32")
    images = np.stack([np.asarray(render(params, params, p)) for p in true])
    base44 = np.asarray(jpo.as_homogeneous(jpo.perturb_poses(true, jax.random.PRNGKey(5),
                                                             1.5, 0.03)), np.float32)
    steps = 3
    # The pixels JAX's loops draw at step i for global image g.
    pixels = np.stack([
        np.stack([np.asarray(jax.random.randint(
            jax.random.fold_in(jax.random.split(jax.random.fold_in(
                jax.random.PRNGKey(11), i))[0], g), (RAYS,), 0, POSE_H * POSE_W))
            for g in range(n)]) for i in range(steps)]).astype(np.int64)
    joint0 = jpo.init_joint_train_state(model, model, jax.random.PRNGKey(7), n,
                                        __import__("optax").adam(5e-3),
                                        __import__("optax").adam(3e-3))
    joint = {"coarse": jax.tree.map(np.asarray, joint0.params_coarse),
             "fine": jax.tree.map(np.asarray, joint0.params_fine)}
    ranks = _spawn(_pose_rank, params, base44, images, pixels, joint)
    return dict(model=model, params=params, js=js, base44=base44, images=images,
                joint0=joint0, steps=steps, ranks=ranks)


# --------------------------------------------------------------------------
# The data-parallel train step


def _jax_dp_step(pc, pf, batch):
    import jax
    import jax.numpy as jnp

    from nerf_tpu.engine.renderer import RenderSettings as JaxSettings
    from nerf_tpu.engine.train import TrainState, make_optimizer
    from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
    from nerf_tpu.parallel import make_mesh, make_parallel_train_step, replicate_tree, shard_batch

    model = JaxFlexible(**NARROW)
    opt = make_optimizer("adam", 1e-3)
    pcj, pfj = jax.tree.map(jnp.asarray, pc), jax.tree.map(jnp.asarray, pf)
    state = TrainState(jnp.asarray(0, jnp.int32), pcj, pfj, opt.init({"coarse": pcj,
                                                                       "fine": pfj}))
    mesh = make_mesh(2)
    step = make_parallel_train_step(model, model, JaxSettings(**DETERMINISTIC), opt, mesh)
    state, m = step(replicate_tree(mesh, state), *shard_batch(mesh, *batch),
                    jax.random.PRNGKey(5))
    return float(m.loss), jax.tree.map(np.asarray, state.params_coarse), \
        jax.tree.map(np.asarray, state.params_fine)


def test_dp_train_step_matches_jax(train_run):
    loss, want_c, want_f = _jax_dp_step(train_run["pc"], train_run["pf"], train_run["batch"])
    for rank in train_run["ranks"]:
        got = rank["dp"]
        np.testing.assert_allclose(got["loss"], loss, rtol=1e-5)
        for a, b in zip(_leaves(got["coarse"]) + _leaves(got["fine"]),
                        _leaves(want_c) + _leaves(want_f)):
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-6)


def test_dp_train_step_matches_serial_step_on_the_union_batch(train_run):
    """The all-reduce of two half-batch means is the union batch's mean: the
    reduced gradients and the updated weights match the serial step."""
    r0, r1 = train_run["ranks"]
    serial = r0["serial"]
    np.testing.assert_allclose(r0["dp"]["loss"], serial["loss"], rtol=1e-6)
    np.testing.assert_allclose(r0["dp"]["loss"],
                               r0["dp"]["closs"] + r0["dp"]["floss"], rtol=1e-6)
    for g, want in zip(r0["dp"]["grads"], serial["grads"]):
        np.testing.assert_allclose(g, want, rtol=0, atol=1e-6 * max(1.0, np.abs(want).max()))
    for a, b in zip(_leaves(r0["dp"]["coarse"]), _leaves(serial["coarse"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-7)
    # Every rank holds the same reduced gradients and weights, bitwise.
    for a, b in zip(r0["dp"]["grads"] + _leaves(r0["dp"]["fine"]),
                    r1["dp"]["grads"] + _leaves(r1["dp"]["fine"])):
        np.testing.assert_array_equal(a, b)


def test_dp_loop_stochastic_steps_keep_ranks_equal_and_learn(train_run):
    r0, r1 = train_run["ranks"]
    assert r0["loop"]["step"] == r1["loop"]["step"] == 5
    np.testing.assert_array_equal(r0["loop"]["losses"], r1["loop"]["losses"])
    for a, b in zip(_leaves(r0["loop"]["coarse"]) + _leaves(r0["loop"]["fine"]),
                    _leaves(r1["loop"]["coarse"]) + _leaves(r1["loop"]["fine"])):
        np.testing.assert_array_equal(a, b)
    losses = r0["loop"]["losses"]
    assert np.all(np.isfinite(losses)) and losses[-1] < losses[0], losses


def test_dp_nan_guard_skips_the_update_on_every_rank(train_run):
    """A NaN target on rank 1 alone: the reduced loss is NaN on both ranks,
    so both skip the update (the weights stay the initial ones, the
    schedule's count stays 0) and only the step moves."""
    init = _leaves(train_run["pc"]) + _leaves(train_run["pf"])
    for rank in train_run["ranks"]:
        guard = rank["guard"]
        assert np.isnan(guard["loss"]) and guard["step"] == 1 and guard["count"] == 0
        for a, b in zip(_leaves(guard["coarse"]) + _leaves(guard["fine"]), init):
            np.testing.assert_array_equal(a, b)


# --------------------------------------------------------------------------
# Renders and the sigma grid


def _close(got, want, tol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=0, atol=tol)


def test_sharded_image_and_flat_renders_match_jax_and_serial(render_run):
    import jax.numpy as jnp

    from nerf_tpu.engine.renderer import RenderSettings as JaxSettings
    from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
    from nerf_tpu.parallel import make_mesh, make_parallel_image_render_fn

    r0, r1 = render_run["ranks"]
    assert r1["image"] is None and r1["flat"] is None and r1["grid"] is None
    model = JaxFlexible(**NARROW)
    ro, rd = render_run["rays"]
    want = make_parallel_image_render_fn(
        model, model, JaxSettings(**DETERMINISTIC, chunksize=16), make_mesh(2))(
        render_run["pc"], render_run["pf"], jnp.asarray(ro), jnp.asarray(rd))
    assert set(r0["image"]) == set(want)
    for k in want:
        assert r0["image"][k].shape == want[k].shape == (H, W) + want[k].shape[2:]
        _close(r0["image"][k], want[k], 1e-5 * max(1.0, float(np.abs(want[k]).max())))
        _close(r0["image"][k], r0["serial_image"][k], 1e-6)
        _close(r0["flat"][k], r0["serial_image"][k].reshape((H * W,) + want[k].shape[2:])[:62],
               1e-6)


def test_sharded_pose_render_matches_jax_and_serial(render_run):
    import jax.numpy as jnp

    from nerf_tpu.engine.renderer import RenderSettings as JaxSettings
    from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
    from nerf_tpu.parallel import make_mesh, make_parallel_pose_render_fn

    r0, r1 = render_run["ranks"]
    assert r1["pose"] is None and r1["pose_u8"] is None
    model = JaxFlexible(**NARROW)
    want = make_parallel_pose_render_fn(
        model, model, JaxSettings(**DETERMINISTIC, chunksize=16), H, W, FOCAL, make_mesh(2))(
        render_run["pc"], render_run["pf"], jnp.asarray(render_run["pose"]))
    for k in ("rgb_coarse", "rgb_fine", "acc_fine", "depth_fine"):
        _close(r0["pose"][k], want[k], 1e-5 * max(1.0, float(np.abs(want[k]).max())))
    for k in r0["serial_pose"]:
        _close(r0["pose"][k], r0["serial_pose"][k], 1e-6)
    np.testing.assert_array_equal(r0["pose_u8"], r0["serial_pose"]["rgb_u8"])
    assert r0["pose_u8"].dtype == np.uint8 and r0["pose_u8"].shape == (H, W, 3)


def test_sharded_sigma_grid_is_bitwise_serial_and_matches_jax(render_run):
    from nerf_tpu.engine.renderer import RenderSettings as JaxSettings
    from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
    from nerf_tpu.parallel import make_mesh
    from nerf_tpu.parallel.geometry import make_parallel_sigma_grid_fn

    r0 = render_run["ranks"][0]
    res, lo, hi, chunk = render_run["grid_args"]
    np.testing.assert_array_equal(r0["grid"], r0["serial_grid"])
    assert r0["grid"].shape == (res,) * 3 and r0["grid"].dtype == np.float32
    model = JaxFlexible(**NARROW)
    want = make_parallel_sigma_grid_fn(model, JaxSettings(**DETERMINISTIC), res, lo, hi,
                                       make_mesh(2), chunk=chunk)(render_run["pf"])
    _close(r0["grid"], want, 1e-5 * max(1.0, float(np.abs(want).max())))
    assert float(r0["grid"].max()) > 0


# --------------------------------------------------------------------------
# Pose refinement


def test_pose_dp_loop_matches_jax(pose_run):
    import jax
    import optax

    from nerf_tpu.engine.pose_opt import init_pose_opt_state
    from nerf_tpu.parallel import make_mesh, make_parallel_pose_opt_loop, replicate_tree
    from nerf_tpu.parallel import shard_batch

    n = pose_run["images"].shape[0]
    mesh = make_mesh(2)
    opt = optax.adam(3e-3)
    loop = make_parallel_pose_opt_loop(pose_run["model"], pose_run["model"], pose_run["js"],
                                       POSE_H, POSE_W, FOCAL * 1.05, RAYS, opt,
                                       steps_per_loop=pose_run["steps"], mesh=mesh,
                                       num_images=n, refine_focal=True)
    base_s, images_s = shard_batch(mesh, pose_run["base44"], pose_run["images"])
    params = replicate_tree(mesh, pose_run["params"])
    state, losses = loop(replicate_tree(mesh, init_pose_opt_state(n, opt)), base_s, images_s,
                         params, params, jax.random.PRNGKey(11))
    for rank in pose_run["ranks"]:
        got = rank["pose"]
        np.testing.assert_allclose(got["losses"], np.asarray(losses), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["xi"], np.asarray(state.xi), rtol=0, atol=1e-5)
        np.testing.assert_allclose(got["log_focal"], float(state.log_focal), atol=3e-6)
    assert np.abs(pose_run["ranks"][0]["pose"]["xi"]).max() > 1e-4
    assert abs(pose_run["ranks"][0]["pose"]["log_focal"]) > 1e-6
    np.testing.assert_array_equal(pose_run["ranks"][0]["pose"]["xi"],
                                  pose_run["ranks"][1]["pose"]["xi"])


def test_pose_dp_joint_loop_matches_jax(pose_run):
    """Against JAX's data-parallel joint loop: losses and twists at
    ``tests/test_pose_dp.py``'s tolerances; the NeRF weights to 1e-4, since
    Adam moves a weight whose gradient is near zero by about lr a step
    whatever the gradient's rounding (one of 432 read 7e-5 after 3 steps).
    Against the port's serial joint loop on the same pixels, to 1e-5."""
    import jax
    import optax

    from nerf_tpu.parallel import make_mesh, make_parallel_joint_train_loop, replicate_tree
    from nerf_tpu.parallel import shard_batch

    n = pose_run["images"].shape[0]
    mesh = make_mesh(2)
    loop = make_parallel_joint_train_loop(pose_run["model"], pose_run["model"], pose_run["js"],
                                          POSE_H, POSE_W, FOCAL, RAYS, optax.adam(5e-3),
                                          optax.adam(3e-3), steps_per_loop=pose_run["steps"],
                                          mesh=mesh, num_images=n)
    base_s, images_s = shard_batch(mesh, pose_run["base44"], pose_run["images"])
    state, losses = loop(replicate_tree(mesh, pose_run["joint0"]), base_s, images_s,
                         jax.random.PRNGKey(11))
    for rank in pose_run["ranks"]:
        got = rank["joint"]
        np.testing.assert_allclose(got["losses"], np.asarray(losses), rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["xi"], np.asarray(state.pose.xi), rtol=0, atol=1e-5)
        assert np.abs(got["xi"][0]).max() == 0.0     # camera 0 anchored
        for a, b in zip(_leaves(got["coarse"]), _leaves(jax.tree.map(np.asarray,
                                                                      state.params_coarse))):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    got, serial = pose_run["ranks"][0]["joint"], pose_run["ranks"][0]["joint_serial"]
    np.testing.assert_allclose(got["losses"], serial["losses"], rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got["xi"], serial["xi"], rtol=0, atol=1e-5)
    for a, b in zip(_leaves(got["coarse"]), _leaves(serial["coarse"])):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    assert np.abs(got["xi"][1:]).max() > 1e-4


# --------------------------------------------------------------------------
# Multi-scene


def test_multiscene_dp_step_matches_the_one_device_step(train_run):
    r0, r1 = train_run["ranks"]
    got, want = r0["ms"], r0["ms_serial"]
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_allclose(got["closs"], want["closs"], rtol=1e-5)
    for k, g in want["grads"].items():
        scale = np.abs(g).reshape(2, -1).max(axis=1).reshape((2,) + (1,) * (g.ndim - 1))
        assert np.all(np.abs(got["grads"][k] - g) <= 1e-5 * np.maximum(scale, 1e-12)), k
        np.testing.assert_allclose(got["params"][k], want["params"][k], rtol=0, atol=1e-6)
    for k in got["params"]:
        np.testing.assert_array_equal(got["params"][k], r1["ms"]["params"][k])


def test_multiscene_dp_loop_keeps_ranks_equal(train_run):
    r0, r1 = train_run["ranks"]
    assert r0["ms_loop"]["step"] == 3 and r0["ms_loop"]["losses"].shape == (3, 2)
    assert np.all(np.isfinite(r0["ms_loop"]["losses"]))
    np.testing.assert_array_equal(r0["ms_loop"]["losses"], r1["ms_loop"]["losses"])
    for k in r0["ms_loop"]["params"]:
        np.testing.assert_array_equal(r0["ms_loop"]["params"][k], r1["ms_loop"]["params"][k])


# --------------------------------------------------------------------------
# Mesh helpers


@pytest.mark.parametrize("n,devices,multiple,want", [
    (100, 8, 1, 104), (64, 8, 1, 64), (1023, 2, 1, 1024), (5, 2, 4, 8), (0, 3, 1, 0)])
def test_pad_to_devices_matches_jax(n, devices, multiple, want):
    from nerf_tpu.parallel import pad_to_devices as jax_pad

    assert tmesh.pad_to_devices(n, devices, multiple) == jax_pad(n, devices, multiple) == want


def test_shard_rows_is_the_jax_shard_batch_layout():
    import jax

    from nerf_tpu.parallel import make_mesh, shard_batch
    from nerf_tpu.parallel.multiscene import shard_multiscene_stores

    arr = np.arange(8 * 3, dtype=np.float32).reshape(8, 3)
    stores = np.arange(2 * 6 * 3, dtype=np.float32).reshape(2, 6, 3)
    for devices in (2, 4):
        mesh = make_mesh(devices)
        by_device = {s.device: np.asarray(s.data) for s in shard_batch(mesh, arr)
                     .addressable_shards}
        ms_by_device = None if 6 % devices else {
            s.device: np.asarray(s.data)
            for s in shard_multiscene_stores(mesh, stores).addressable_shards}
        for r, dev in enumerate(mesh.devices.flat):
            local = tmesh.Mesh(devices, r, torch.device("cpu"))
            np.testing.assert_array_equal(tmesh.shard_rows(local, arr), by_device[dev])
            got = tmesh.shard_rows(local, torch.from_numpy(arr))
            np.testing.assert_array_equal(got.numpy(), by_device[dev])
            if ms_by_device is not None:
                np.testing.assert_array_equal(tmesh.shard_rows(local, stores, axis=1),
                                              ms_by_device[dev])
    assert jax.device_count() == 8
    with pytest.raises(ValueError, match="do not divide over 4 ranks"):
        tmesh.shard_rows(tmesh.Mesh(4, 0, torch.device("cpu")), stores, axis=1)


def test_one_rank_mesh_without_a_group_is_the_identity():
    mesh = tmesh.make_mesh(1, "cpu")
    assert (mesh.world_size, mesh.rank, mesh.group) == (1, 0, None) and mesh.is_primary
    t = torch.arange(4.0)
    assert tmesh.all_reduce_mean(mesh, [t])[0] is t
    assert tmesh.gather_rows(mesh, t) is t
    with pytest.raises(ValueError, match="need a process group"):
        tmesh.make_mesh(2, "cpu")
    assert tdist.is_primary()


def test_nccl_is_refused_for_ranks_on_the_cpu_or_sharing_a_card(monkeypatch):
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        tdist.check_backend("nccl", "cpu", 1)
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        tdist.run_ranks(_train_rank, 2, backend="nccl", device="cpu")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="2 ranks on this host share 1 card"):
        tdist.check_backend("nccl", "cuda", 2)
    with pytest.raises(ValueError, match="take --dist-backend gloo"):
        tdist.run_ranks(_train_rank, 2, backend="nccl", device="cuda")
    tdist.check_backend("nccl", "cuda", 1)    # a card a rank
    tdist.check_backend("gloo", "cuda", 2)    # ranks that share a card, through gloo
    assert tdist.default_backend("cuda") == "nccl" and tdist.default_backend("cpu") == "gloo"
    assert tdist.rank_device("cuda", 3) == torch.device("cuda", 0)
    assert tdist.rank_device("cuda:0", 3) == torch.device("cuda", 0)
    assert tdist.rank_device("cpu", 1) == torch.device("cpu")


def test_maybe_initialize_distributed_without_torchrun_does_nothing(monkeypatch):
    for name in ("RANK", "WORLD_SIZE", "MASTER_ADDR"):
        monkeypatch.delenv(name, raising=False)
    assert tdist.maybe_initialize_distributed("gloo", "cpu") is False
    assert not torch.distributed.is_initialized()
    assert tdist.spawn_or_join(2, "gloo", "cpu") is True
    assert tdist.spawn_or_join(1, "gloo", "cpu") is False


_TORCHRUN_RANK = """
import torch
from nerf_tpu_torch.parallel import distributed, mesh
assert distributed.maybe_initialize_distributed(None, "cpu", 60)
assert distributed.spawn_or_join(2, None, "cpu") is False
m = mesh.make_mesh(2, "cpu")
t = torch.full((3,), float(m.rank) + 1.0)
mesh.all_reduce_mean(m, [t])
print("RANK_OK", m.rank, m.world_size, m.backend, distributed.is_primary(), t.tolist())
"""


def test_maybe_initialize_distributed_joins_the_torchrun_group():
    """Two processes with torchrun's environment (RANK, WORLD_SIZE,
    MASTER_ADDR/PORT on localhost) join one gloo group."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _TORCHRUN_RANK], stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO, "RANK": str(r), "LOCAL_RANK": str(r),
             "WORLD_SIZE": "2", "LOCAL_WORLD_SIZE": "2", "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": str(port), "OMP_NUM_THREADS": "1"}) for r in range(2)]
    try:
        outs = [p.communicate(timeout=120) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()   # a hung pair must not outlive the test
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, err[-3000:]
        assert f"RANK_OK {r} 2 gloo {r == 0} [1.5, 1.5, 1.5]" in out

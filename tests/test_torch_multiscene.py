"""nerf_tpu_torch.parallel.multiscene and the multi-scene CLIs against the JAX
package.

- The scene-vmapped step against JAX ``make_multiscene_train_step`` on the
  same stacked weights and batches, with jitter, sigma noise and the
  resample uniforms drawn from JAX's per-scene keys and injected into the
  port: losses to rtol 1e-5 over 3 steps. Parameters: with SGD to atol 1e-6
  after every step; with Adam to atol 5e-6 (1e-3 of the lr) after the first
  step, since Adam divides each gradient element by its own magnitude and
  an element near 0 carries its float32 rounding (~1e-4 relative, from
  sums in another order) into its step.
- Scene ``s`` of the port's multi-scene loop against the port's
  single-scene loop on scene ``s``'s store, state and seed
  ``fold_seed(base, s)``: the same generator streams, so the losses agree
  to rtol 1e-6 and the parameters to 1e-6 (the batched products sum in
  another order than the single ones); scene 0's run is the same, to those
  tolerances, whether it trains alone or beside two other scenes.
- ``sample_multiscene_batch``'s shapes in both modes against JAX's, and
  each scene's batch is ``sample_ray_batch``'s from its generator.
- ``train_multiscene --save-dir``: the export layout (files, keys, types,
  shapes, dtypes, step) of the JAX CLI run on the CPU with the same flags,
  synthetic scenes and a blender + LLFF pair of groups; every exported
  ``.ntc`` renders through ``eval_nerf``; duplicate scene names refuse.
  ``eval_multiscene``'s JSON summary on those checkpoints and distilled
  datasets (blender, and LLFF found by its ``poses_bounds.npy``) against the
  JAX CLI's on the same files: the same keys, each rounded value within one
  unit of its last place.
"""

import contextlib
import dataclasses
import importlib
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine import train as jtrain
from nerf_tpu.engine.checkpoint import load_checkpoint as jax_load_checkpoint
from nerf_tpu.engine.checkpoint import to_torch_state_dict
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.parallel import multiscene as jms
from nerf_tpu_torch import distill_dataset, eval_multiscene, eval_nerf, train_multiscene
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import load_checkpoint, load_jax_params
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.parallel import multiscene as tms
from nerf_tpu_torch.utils.profiling import RENDER_FIELD

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(num_layers=2, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=3,
              num_encoding_fn_dir=2)
ENC = {k: NARROW[k] for k in ("num_encoding_fn_xyz", "num_encoding_fn_dir")}
S, B, NC, NF = 3, 16, 8, 8


def _settings(**kw):
    base = dict(num_coarse=NC, num_fine=NF, perturb=True, radiance_field_noise_std=0.2,
                white_background=True, near=2.0, far=6.0, **ENC)
    base.update(kw)
    return jrend.RenderSettings(**base), trend.RenderSettings(**base)


def _batches(seed, steps, s=S, b=B):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ro = (rng.uniform(-0.3, 0.3, (s, b, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
        rd = (rng.normal(size=(s, b, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
        out.append((ro, rd, rng.uniform(0, 1, (s, b, 3)).astype(np.float32)))
    return out


def _jax_draws(key, s=S, b=B):
    """The numbers JAX's vmapped step draws for each scene, stacked."""
    fields = [[], [], [], []]
    for k in jax.random.split(key, s):
        kp, knc, kf, knf = jax.random.split(k, 4)
        fields[0].append(jax.random.uniform(kp, (b, NC)))
        fields[1].append(jax.random.normal(knc, (b, NC)))
        fields[2].append(jax.random.uniform(kf, (b, NF)))
        fields[3].append(jax.random.normal(knf, (b, NC + NF)))
    return trend.RenderDraws(*(torch.from_numpy(np.stack([np.asarray(x) for x in f]))
                               for f in fields))


def _port_state_from_jax(jstate, spec):
    tmodel = FlexibleNeRFModel(**NARROW)
    state = tms.create_multiscene_state(tmodel, tmodel, spec, 0, S)
    with torch.no_grad():
        for which, tree in (("coarse", jstate.params_coarse), ("fine", jstate.params_fine)):
            for s in range(S):
                sd = to_torch_state_dict(jax.tree.map(lambda x: np.asarray(x[s]), tree))
                for k, v in sd.items():
                    state.params[f"{which}.{k}"][s].copy_(torch.from_numpy(v))
    return tmodel, state


def _assert_params_match(state, jstate, atol):
    for which, tree in (("coarse", jstate.params_coarse), ("fine", jstate.params_fine)):
        for s in range(S):
            sd = to_torch_state_dict(jax.tree.map(lambda x: np.asarray(x[s]), tree))
            for k, v in sd.items():
                np.testing.assert_allclose(state.params[f"{which}.{k}"][s].detach().numpy(), v,
                                           rtol=0, atol=atol, err_msg=f"{which}.{k}[{s}]")


@pytest.mark.parametrize("name", ["sgd", "adam"])
def test_multiscene_step_matches_jax(name):
    jmodel = JaxFlexible(**NARROW)
    opt = jtrain.make_optimizer(name, 5e-3, 250.0, 0.1)
    jstate = jms.create_multiscene_state(jmodel, jmodel, opt, jax.random.PRNGKey(0), S)
    spec = ttrain.make_optimizer(name, 5e-3, 250.0, 0.1)
    tmodel, state = _port_state_from_jax(jstate, spec)
    js, ts = _settings()
    jstep = jms.make_multiscene_train_step(jmodel, jmodel, js, opt, jit=False)
    tstep = tms.make_multiscene_train_step(tmodel, tmodel, ts)
    for i, (ro, rd, tgt) in enumerate(_batches(1, 3)):
        key = jax.random.PRNGKey(100 + i)
        jstate, jm = jstep(jstate, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), key)
        state, tm = tstep(state, torch.from_numpy(ro), torch.from_numpy(rd),
                          torch.from_numpy(tgt), draws=_jax_draws(key))
        for got, want in zip(tm, jm):
            assert got.shape == (S,)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
        if name == "sgd":
            _assert_params_match(state, jstate, atol=1e-6)
        elif i == 0:
            _assert_params_match(state, jstate, atol=5e-6)
    assert state.step == 3 and int(jstate.step[0]) == 3


def _single_scene_runs(store, s_of, base_seed, settings, steps, k):
    """Each scene of a multi-scene state trained alone by the single-scene loop."""
    spec = ttrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    model = FlexibleNeRFModel(**NARROW)
    ms = tms.create_multiscene_state(model, model, spec, 0, len(s_of))
    out = []
    for s in s_of:
        tc, tf = FlexibleNeRFModel(**NARROW), FlexibleNeRFModel(**NARROW)
        tc.load_state_dict(ms.scene_params(s, "coarse"))
        tf.load_state_dict(ms.scene_params(s, "fine"))
        state = ttrain.create_train_state(tc, tf, spec)
        loop = ttrain.make_train_loop(tc, tf, settings, B, k)
        losses = []
        for _ in range(steps // k):
            state, m = loop(state, *(x[s] for x in store), ttrain.fold_seed(base_seed, s))
            losses += m.loss.tolist()
        out.append((losses, tc.state_dict(), tf.state_dict()))
    return out


def _store(seed, s=S, n=200):
    rng = np.random.default_rng(seed)
    ro = (rng.uniform(-0.3, 0.3, (s, n, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = (rng.normal(size=(s, n, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (ro, rd, rng.uniform(0, 1, (s, n, 3))
                                                .astype(np.float32)))


@pytest.mark.parametrize("k", [1, 2])
def test_each_scene_equals_the_single_scene_loop(k):
    _, ts = _settings()
    store = _store(2)
    spec = ttrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    model = FlexibleNeRFModel(**NARROW)
    state = tms.create_multiscene_state(model, model, spec, 0, S)
    loop = tms.make_multiscene_train_loop(model, model, ts, B, k)
    losses = []
    for _ in range(4 // k):
        state, m = loop(state, *store, 9)
        assert m.loss.shape == (k, S)
        losses.append(m.loss)
    losses = torch.cat(losses)
    for s, (want, sd_c, sd_f) in enumerate(_single_scene_runs(store, range(S), 9, ts, 4, k)):
        np.testing.assert_allclose(losses[:, s].numpy(), want, rtol=1e-6)
        for which, sd in (("coarse", sd_c), ("fine", sd_f)):
            for name, v in state.scene_params(s, which).items():
                np.testing.assert_allclose(v.numpy(), sd[name].numpy(), rtol=0, atol=1e-6)



def test_the_vmapped_loop_is_the_same_under_a_profiler():
    """The field's span inside the scene-vmapped body records under a
    profiler and changes nothing of the step."""
    _, ts = _settings()
    store = _store(2)
    spec = ttrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    model = FlexibleNeRFModel(**NARROW)
    losses = []
    for profiled in (False, True):
        state = tms.create_multiscene_state(model, model, spec, 0, S)
        loop = tms.make_multiscene_train_loop(model, model, ts, B, 2)
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) \
                if profiled else contextlib.nullcontext() as prof:
            losses.append(loop(state, *store, 9)[1].loss)
    assert torch.equal(losses[0], losses[1])
    fields = [e for e in prof.events() if e.name == RENDER_FIELD]
    assert len(fields) == 2 * 2     # coarse and fine, two steps

def test_a_scene_does_not_depend_on_the_others():
    _, ts = _settings()
    spec = ttrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    model = FlexibleNeRFModel(**NARROW)
    three = _store(3)
    alone = tuple(x[:1] for x in three)
    other = tuple(torch.cat([x[:1], y[1:]]) for x, y in zip(three, _store(4)))
    runs = []
    for store in (alone, three, other):
        state = tms.create_multiscene_state(model, model, spec, 0, store[0].shape[0])
        state, m = tms.make_multiscene_train_loop(model, model, ts, B, 3)(state, *store, 5)
        runs.append((m.loss[:, 0], state.scene_params(0, "fine")))
    for losses, params in runs[1:]:
        np.testing.assert_allclose(losses.numpy(), runs[0][0].numpy(), rtol=1e-6)
        for name, v in params.items():
            np.testing.assert_allclose(v.numpy(), runs[0][1][name].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("mode", ["gather", "sliced"])
def test_sample_multiscene_batch(mode):
    ro, rd, tgt = _store(5, n=50)
    gens = [torch.Generator().manual_seed(s) for s in range(S)]
    got = tms.sample_multiscene_batch(gens, ro, rd, tgt, 20, mode=mode)
    want = jms.sample_multiscene_batch(jax.random.PRNGKey(0), *(jnp.asarray(x.numpy())
                                                                for x in (ro, rd, tgt)),
                                       20, mode=mode)
    assert [tuple(x.shape) for x in got] == [tuple(x.shape) for x in want] == [(S, 20, 3)] * 3
    for s in range(S):
        one = ttrain.sample_ray_batch(torch.Generator().manual_seed(s), ro[s], rd[s], tgt[s],
                                      20, mode=mode)
        for a, b in zip(got, one):
            assert torch.equal(a[s], b)
    if mode == "sliced":
        with pytest.raises(ValueError, match="store size >= batch"):
            tms.sample_multiscene_batch(gens, ro, rd, tgt, 51, mode=mode)
    with pytest.raises(ValueError, match="generators"):
        tms.sample_multiscene_batch(gens[:2], ro, rd, tgt, 20, mode=mode)


def test_multi_device_entry_points_raise_naming_the_roadmap():
    """The data-parallel multi-scene path is ported
    (tests/test_torch_parallel.py, tests/test_torch_parallel_cli.py); what
    it cannot do raises: a batch or a store the ranks do not divide, NCCL
    for ranks on the CPU, a batch the CLI's mesh does not divide."""
    from nerf_tpu_torch.parallel.mesh import Mesh

    mesh = Mesh(2, 1, torch.device("cpu"))
    _, ts = _settings()
    with pytest.raises(ValueError, match="not divisible by 2 ranks"):
        tms.make_parallel_multiscene_train_loop(None, None, ts, mesh, 33, 1)
    with pytest.raises(ValueError, match="do not divide over 2 ranks"):
        tms.shard_multiscene_stores(mesh, np.zeros((2, 5, 3)))
    np.testing.assert_array_equal(
        tms.shard_multiscene_stores(mesh, np.arange(8).reshape(1, 4, 2)), [[[4, 5], [6, 7]]])
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        train_multiscene.main(["--num-devices", "2", "--device", "cpu", "--dist-backend", "nccl",
                               "--batch", "32"])
    with pytest.raises(SystemExit, match="must be divisible by the 2-device mesh"):
        train_multiscene.main(["--num-devices", "2", "--device", "cpu", "--batch", "33"])


CLI_FLAGS = ["--num-scenes", "2", "--iters", "4", "--size", "8", "--views", "3", "--batch", "16",
             "--num-coarse", "4", "--num-fine", "4", "--n-xyz", "2", "--n-dir", "1",
             "--print-every", "2"]
EVAL_YML = """
experiment: {{id: ms, logdir: {logdir}}}
dataset: {{type: blender, basedir: "", half_res: false, near: 2.0, far: 6.0}}
models:
  coarse: {{type: FlexibleNeRFModel, num_layers: 4, hidden_size: 128, skip_connect_every: 4,
           num_encoding_fn_xyz: 2, num_encoding_fn_dir: 1, include_input_xyz: true,
           include_input_dir: true, use_viewdirs: true}}
  fine: {{type: FlexibleNeRFModel, num_layers: 4, hidden_size: 128, skip_connect_every: 4,
         num_encoding_fn_xyz: 2, num_encoding_fn_dir: 1, include_input_xyz: true,
         include_input_dir: true, use_viewdirs: true}}
nerf:
  use_viewdirs: true
  encode_position_fn: positional_encoding
  encode_direction_fn: positional_encoding
  train: {{num_random_rays: 16, chunksize: 4096, perturb: true, num_coarse: 4, num_fine: 4,
          white_background: true, radiance_field_noise_std: 0.2, lindisp: false}}
  validation: {{chunksize: 4096, perturb: false, num_coarse: 4, num_fine: 4,
               white_background: true, radiance_field_noise_std: 0.0, lindisp: false}}
"""


def _run_jax_cli(script, argv, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    module = importlib.import_module(script)
    monkeypatch.setattr(sys, "argv", [f"{script}.py", *argv])
    module.main()


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    d = tmp_path_factory.mktemp("ms")
    result = train_multiscene.main([*CLI_FLAGS, "--save-dir", str(d / "port"), "--device", "cpu"])
    cfg = d / "ms.yml"
    cfg.write_text(EVAL_YML.format(logdir=str(d / "logs")))
    return d, result, str(cfg)


def _layout(root):
    out = {}
    for scene in sorted(os.listdir(root)):
        for name in sorted(os.listdir(os.path.join(root, scene))):
            ckpt = jax_load_checkpoint(os.path.join(root, scene, name))
            out[(scene, name)] = jax.tree.map(
                lambda x: (type(x).__name__, np.shape(x), np.asarray(x).dtype.str), ckpt
            ), int(ckpt["step"])
    return out


def test_train_multiscene_export_matches_the_jax_cli(exported, monkeypatch):
    # The JAX CLI sees the suite's 8 virtual CPU devices and takes its
    # data-parallel path; the export layout is the same.
    d, result, cfg = exported
    _run_jax_cli("train_multiscene", [*CLI_FLAGS, "--save-dir", str(d / "jax")], monkeypatch)
    assert _layout(str(d / "port")) == _layout(str(d / "jax"))
    assert sorted(os.listdir(d / "port")) == ["scene0", "scene1"]
    assert result.groups == {"blender": ["scene0", "scene1"]}
    assert [x.shape for x in result.losses["blender"]] == [(2, 2), (2, 2)]
    # Every export renders through the port's eval_nerf.
    for scene in ("scene0", "scene1"):
        ckpt = os.path.join(d, "port", scene, "checkpoint00004.ntc")
        assert float(load_checkpoint(ckpt)["loss"]) == pytest.approx(
            float(result.losses["blender"][-1][-1][int(scene[-1])]))
        out = eval_nerf.main(["--config", cfg, "--checkpoint", ckpt, "--num-poses", "1",
                              "--savedir", str(d / "eval" / scene), "--device", "cpu",
                              "--overrides", "dataset.type", "synthetic"])
        assert all(out.finite)


def test_eval_multiscene_summary_matches_the_jax_cli(exported, monkeypatch, capsys):
    d, _, cfg = exported
    from nerf_tpu_torch.config import load_config

    for scene in ("scene0", "scene1"):
        distill_dataset.distill(load_config(cfg), str(d / "port" / scene / "checkpoint00004.ntc"),
                                str(d / "data" / scene), num_train=1, num_val=2, num_test=1,
                                size=8, device="cpu")
    args = ["--config", cfg, "--ckpt-root", str(d / "port"), "--data-root", str(d / "data"),
            "--no-half-res"]
    capsys.readouterr()
    _run_jax_cli("eval_multiscene", [*args, "--renderer", "xla", "--savedir", str(d / "jr")],
                 monkeypatch)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_multiscene.main([*args, "--device", "cpu", "--savedir", str(d / "tr")])
    assert json.loads(capsys.readouterr().out.strip().splitlines()[-1]) == got
    for summary in (want, got):
        summary.pop("elapsed_s")
    assert got.keys() == want.keys() and got["scenes"].keys() == want["scenes"].keys()
    assert got["psnr_mean_over_scenes"] == pytest.approx(want["psnr_mean_over_scenes"], abs=1e-3)
    for scene, r in want["scenes"].items():
        g = got["scenes"][scene]
        assert {k: g[k] for k in ("checkpoint", "step", "num_views")} == {
            k: r[k] for k in ("checkpoint", "step", "num_views")}
        assert g["psnr_mean"] == pytest.approx(r["psnr_mean"], abs=1e-3)
        assert g["psnr_min"] == pytest.approx(r["psnr_min"], abs=1e-3)
        assert g["ssim_mean"] == pytest.approx(r["ssim_mean"], abs=1e-4)
        assert sorted(os.listdir(d / "tr" / scene)) == ["val_000.png", "val_001.png"]


LLFF_YML = EVAL_YML.replace("type: blender, basedir: \"\", half_res: false, near: 2.0, far: 6.0",
                            "type: llff, basedir: \"\", no_ndc: false, near: 0.0, far: 1.0, "
                            "llffhold: 8").replace("white_background: true", "white_background: false")


@pytest.fixture(scope="module")
def two_groups(exported):
    """A distilled blender set and a distilled LLFF set of scene0's field."""
    d, _, cfg = exported
    from nerf_tpu_torch.config import load_config

    llff_cfg = d / "llff.yml"
    llff_cfg.write_text(LLFF_YML.format(logdir=str(d / "logs")))
    teacher = str(d / "port" / "scene0" / "checkpoint00004.ntc")
    data = d / "data2"
    distill_dataset.distill(load_config(cfg), teacher, str(data / "bl"), num_train=2,
                            num_val=2, num_test=1, size=8, device="cpu")
    distill_dataset.distill(load_config(str(llff_cfg)), teacher, str(data / "ff"), num_train=7,
                            num_val=2, size=16, device="cpu")
    flags = ["--blender-dirs", str(data / "bl"), "--llff-dirs", str(data / "ff"),
             "--no-half-res", "--iters", "2", "--batch", "16", "--num-coarse", "4",
             "--num-fine", "4", "--n-xyz", "2", "--n-dir", "1", "--llff-n-xyz", "2",
             "--print-every", "2"]
    return d, data, cfg, str(llff_cfg), flags


def test_two_groups_match_the_jax_cli(two_groups, monkeypatch, capsys):
    d, data, cfg, llff_cfg, flags = two_groups
    result = train_multiscene.main([*flags, "--save-dir", str(d / "port2"), "--device", "cpu"])
    assert result.groups == {"blender": ["bl"], "llff": ["ff"]}
    _run_jax_cli("train_multiscene", [*flags, "--save-dir", str(d / "jax2")], monkeypatch)
    assert _layout(str(d / "port2")) == _layout(str(d / "jax2"))
    args = ["--config", cfg, "--llff-config", llff_cfg, "--ckpt-root", str(d / "port2"),
            "--data-root", str(data), "--no-half-res", "--split", "val"]
    capsys.readouterr()
    _run_jax_cli("eval_multiscene", [*args, "--renderer", "xla"], monkeypatch)
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    got = eval_multiscene.main([*args, "--device", "cpu"])
    for summary in (want, got):
        summary.pop("elapsed_s")
    assert got["scenes"].keys() == want["scenes"].keys() == {"bl", "ff"}
    assert got["scenes"]["ff"]["num_views"] == want["scenes"]["ff"]["num_views"] == 2
    for scene, r in want["scenes"].items():
        g = got["scenes"][scene]
        assert (g["checkpoint"], g["step"]) == (r["checkpoint"], r["step"])
        assert g["psnr_mean"] == pytest.approx(r["psnr_mean"], abs=1e-3)
        assert g["ssim_mean"] == pytest.approx(r["ssim_mean"], abs=1e-4)


def test_duplicate_scene_names_refuse(two_groups, tmp_path):
    d, data, _, _, flags = two_groups
    import shutil

    shutil.copytree(data / "bl", tmp_path / "a" / "ff")
    with pytest.raises(SystemExit, match="duplicate scene names"):
        train_multiscene.main(["--blender-dirs", str(tmp_path / "a" / "ff"), "--llff-dirs",
                               str(data / "ff"), "--no-half-res", "--iters", "1", "--batch", "8",
                               "--num-coarse", "4", "--num-fine", "4", "--device", "cpu"])

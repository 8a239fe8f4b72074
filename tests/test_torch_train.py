"""nerf_tpu_torch.engine.train against nerf_tpu.engine.train.

Optimizers, the LR schedule, the loss and whole training steps are held
against the JAX package on the same weights (``load_jax_params``) and the
same numpy ray batches, with ``perturb`` off and no sigma noise, so no
random numbers enter. Parameters are not compared after several Adam steps:
Adam's first update is about lr * sign(g), so a near-zero gradient whose
sign differs by rounding moves a weight by 2 * lr. Losses are, to rtol 2e-3
(the JAX package's trajectory tolerance, tests/test_pallas_flex_train.py).

With ``use_pallas_train`` the JAX side runs its training kernels in interpret
mode (backend gate mocked, as tests/test_pallas_flex_train.py does) and the
port its plain pair, since the tensors lie on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine import train as jtrain
from nerf_tpu.engine.checkpoint import export_reference_checkpoint as jax_export
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch.config import get_default_config, optimizer_from_config
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import (
    convert_torch_state_dict,
    export_reference_checkpoint,
    latest_checkpoint,
    load_jax_params,
    load_train_checkpoint,
    save_checkpoint,
)
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.utils.profiling import (RENDER_FIELD, TRAIN_BACKWARD, TRAIN_DRAW,
                                            TRAIN_FORWARD, TRAIN_UPDATE)
from tests.test_torch_profiling import chrome_spans

torch.set_num_threads(1)
ENC = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
NOT_PORTED = ("rmsprop", "adagrad", "adamax", "adadelta", "nadam", "radam", "rprop")


@pytest.mark.parametrize("step", [0, 1, 1000, 250000])
def test_lr_schedule_matches_optax(step):
    want = float(jtrain.exponential_lr_schedule(5e-3, 250, 0.1)(step))
    spec = ttrain.make_optimizer("Adam", 5e-3, 250, 0.1)
    assert ttrain.exponential_lr_schedule(5e-3, 250, 0.1)(step) == pytest.approx(want, rel=1e-6)
    # The torch schedule, positioned after `step` updates, gives the next update's lr.
    param = torch.nn.Parameter(torch.zeros(2))
    opt = torch.optim.Adam([param], lr=5e-3)
    sched = spec.make_scheduler(opt, count=step)
    assert opt.param_groups[0]["lr"] == pytest.approx(want, rel=1e-6)
    param.grad = torch.zeros(2)
    opt.step()
    sched.step()
    nxt = float(jtrain.exponential_lr_schedule(5e-3, 250, 0.1)(step + 1))
    assert opt.param_groups[0]["lr"] == pytest.approx(nxt, rel=1e-6)


def _toy():
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (3.0 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    return params, grads


@pytest.mark.parametrize("clip", [None, 0.5, 100.0])
@pytest.mark.parametrize("name", ["Adam", "AdamW", "SGD"])
def test_optimizer_steps_match_optax(name, clip):
    params, grads = _toy()
    jopt = jtrain.make_optimizer(name, 5e-3, 0.002, 0.1, grad_clip_norm=clip)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    spec = ttrain.make_optimizer(name, 5e-3, 0.002, 0.1, grad_clip_norm=clip)
    opt, sched = spec.init(tparams)
    for g in grads:
        updates, jstate = jopt.update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        if spec.grad_clip_norm:
            ttrain.clip_by_global_norm([p.grad for p in tparams], spec.grad_clip_norm)
        opt.step()
        sched.step()
        for p, k in zip(tparams, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name", NOT_PORTED)
def test_unported_optimizers_raise_naming_the_roadmap(name):
    # These names are ported (tests/test_torch_optimizers.py holds them to
    # optax): each builds optax's rule and none raises naming the roadmap.
    from nerf_tpu_torch.engine.optimizers import OPTAX_RULES

    opt, _ = ttrain.make_optimizer(name, 1e-3).init([torch.nn.Parameter(torch.zeros(2))])
    assert isinstance(opt, OPTAX_RULES[name])


def test_optimizer_from_config():
    cfg = get_default_config()
    spec = optimizer_from_config(cfg)
    assert (spec.name, spec.lr, spec.lr_decay, spec.lr_decay_factor, spec.grad_clip_norm) == (
        "adam", 5e-3, 250, 0.1, None)
    cfg.merge_from_list(["optimizer.grad_clip_norm", 1.5, "optimizer.type", "SGD"])
    assert optimizer_from_config(cfg).grad_clip_norm == 1.5
    with pytest.raises(ValueError, match="Unsupported optimizer"):
        ttrain.make_optimizer("LBFGS", 1e-3)


def test_sample_ray_batch():
    n = 50
    store = torch.arange(3 * n, dtype=torch.float32).reshape(n, 3)
    gen = torch.Generator().manual_seed(0)
    ro, rd, tgt = ttrain.sample_ray_batch(gen, store, store + 1, store + 2, 16)
    assert ro.shape == rd.shape == tgt.shape == (16, 3)
    rows = (ro[:, 0] / 3).long()
    assert bool(((rows >= 0) & (rows < n)).all())
    assert torch.equal(rd, store[rows] + 1) and torch.equal(tgt, store[rows] + 2)
    ro, _, _ = ttrain.sample_ray_batch(gen, store, store, store, 16, mode="sliced")
    start = int(ro[0, 0]) // 3
    assert 0 <= start <= n - 16 and torch.equal(ro, store[start:start + 16])
    with pytest.raises(ValueError, match="store size"):
        ttrain.sample_ray_batch(gen, store[:8], store[:8], store[:8], 16, mode="sliced")
    with pytest.raises(ValueError, match="unknown ray-sampling mode"):
        ttrain.sample_ray_batch(gen, store, store, store, 4, mode="strided")


def test_step_generator_depends_on_seed_and_step_only():
    a = torch.rand(4, generator=ttrain.step_generator(42, 7, "cpu"))
    b = torch.rand(4, generator=ttrain.step_generator(42, 7, "cpu"))
    c = torch.rand(4, generator=ttrain.step_generator(42, 8, "cpu"))
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert ttrain.steps_per_call(100, 1000, 5000, 250) == 100
    assert ttrain.steps_per_call(100, 1000, 5000, 7) == 7
    assert ttrain.steps_per_call(100, 1000, 5000, 0) == 1


def _narrow_state(lr=5e-3):
    mc = FlexibleNeRFModel(num_layers=2, hidden_size=16, num_encoding_fn_xyz=2,
                           num_encoding_fn_dir=1, generator=torch.Generator().manual_seed(0))
    spec = ttrain.make_optimizer("Adam", lr, 250, 0.1)
    settings = trend.RenderSettings(num_coarse=4, num_fine=0, perturb=False,
                                    num_encoding_fn_xyz=2, num_encoding_fn_dir=1)
    return ttrain.create_train_state(mc, None, spec), settings


def test_nan_guard_skips_the_update():
    state, settings = _narrow_state()
    step = ttrain.make_train_step(state.model_coarse, None, settings, nan_guard=True)
    ro = torch.zeros(8, 3) + torch.tensor([0.0, 0.0, 4.0])
    rd = torch.randn(8, 3, generator=torch.Generator().manual_seed(1)) * 0.1 - torch.tensor(
        [0.0, 0.0, 1.0])
    before = [p.detach().clone() for p in state.params]
    bad = torch.full((8, 3), float("nan"))
    state, metrics = step(state, ro, rd, bad)
    assert state.step == 1 and not bool(torch.isfinite(metrics.loss))
    assert all(torch.equal(a, p) for a, p in zip(before, state.params))
    assert state.optimizer.state == {} or all(
        float(s["step"]) == 0 for s in state.optimizer.state.values())
    assert state.scheduler.last_epoch == 0
    state, metrics = step(state, ro, rd, torch.rand(8, 3, generator=torch.Generator().manual_seed(2)))
    assert state.step == 2 and bool(torch.isfinite(metrics.loss))
    assert not all(torch.equal(a, p) for a, p in zip(before, state.params))
    assert state.scheduler.last_epoch == 1
    assert state.optimizer.param_groups[0]["lr"] == pytest.approx(5e-3 * 0.1 ** (1 / 250000),
                                                                  rel=1e-6)


def _flagship(seed_c=0, seed_f=1):
    jmodel = JaxFlexible(**ENC)
    pc, pf = jmodel.init(jax.random.PRNGKey(seed_c)), jmodel.init(jax.random.PRNGKey(seed_f))
    tc = load_jax_params(FlexibleNeRFModel(**ENC), pc)
    tf = load_jax_params(FlexibleNeRFModel(**ENC), pf)
    return jmodel, pc, pf, tc, tf


def _batch(seed, n=16):
    rng = np.random.default_rng(seed)
    ro = rng.uniform(-0.3, 0.3, (n, 3)).astype(np.float32) + np.float32([0.0, 0.0, 4.0])
    rd = (rng.normal(size=(n, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    tgt = rng.uniform(0, 1, (n, 3)).astype(np.float32)
    return ro, rd, tgt


def _settings(**kw):
    base = dict(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                white_background=True, near=2.0, far=6.0, **ENC)
    base.update(kw)
    return jrend.RenderSettings(**base), trend.RenderSettings(**base)


def test_loss_fn_matches_jax():
    jmodel, pc, pf, tc, tf = _flagship()
    ro, rd, tgt = _batch(3)
    js, ts = _settings()
    jloss = jtrain.make_loss_fn(jmodel, jmodel, js)
    (want, (wc, wf)), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        {"coarse": pc, "fine": pf}, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), None)
    loss, (closs, floss) = ttrain.make_loss_fn(tc, tf, ts)(
        torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tgt))
    loss.backward()
    np.testing.assert_allclose([float(loss.detach()), float(closs.detach()), float(floss.detach())],
                               [float(want), float(wc), float(wf)], rtol=1e-5)
    for which, model in (("coarse", tc), ("fine", tf)):
        got = convert_torch_state_dict({k: p.grad for k, p in model.named_parameters()})
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jgrads[which])):
            b = np.asarray(b)
            scale = max(np.abs(b).max(), 1e-3)
            np.testing.assert_allclose(np.asarray(a) / scale, b / scale, atol=3e-4)


@pytest.fixture
def jax_train_kernels_on_cpu(monkeypatch):
    """Let the JAX renderer reach its training kernels here, in interpret mode."""
    import nerf_tpu.ops.pallas.flex_train as ft_mod

    real = ft_mod.fused_flex_mlp_train
    calls = []

    def interpret(*args, **kwargs):
        calls.append(1)
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(ft_mod, "fused_flex_mlp_train", interpret)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return calls


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
        state, m = step(state, torch.from_numpy(ro), torch.from_numpy(rd), torch.from_numpy(tgt))
        losses.append(float(m.loss))
    return state, losses


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "use_pallas_train"])
def test_train_steps_match_jax(kernels, request):
    calls = request.getfixturevalue("jax_train_kernels_on_cpu") if kernels else None
    jmodel = JaxFlexible(**ENC)
    opt = jtrain.make_optimizer("Adam", 5e-3, 250, 0.1)
    jstate = jtrain.create_train_state(jmodel, jmodel, opt, jax.random.PRNGKey(0))
    tc = load_jax_params(FlexibleNeRFModel(**ENC), jax.tree.map(np.asarray, jstate.params_coarse))
    tf = load_jax_params(FlexibleNeRFModel(**ENC), jax.tree.map(np.asarray, jstate.params_fine))
    tstate = ttrain.create_train_state(tc, tf, ttrain.make_optimizer("Adam", 5e-3, 250, 0.1))
    js, ts = _settings(use_pallas_train=kernels)
    batches = [_batch(10 + i) for i in range(3)]
    _, want = _jax_steps(jmodel, jstate, js, batches, opt)
    if kernels:
        assert len(calls) == 6           # coarse + fine, 3 steps
    tstate, got = _port_steps(tstate, ts, batches)
    assert tstate.step == 3
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_resume_from_a_jax_checkpoint(tmp_path):
    """JAX takes two steps and exports a .ckpt with its Adam state; the port
    resumes from it; both take steps 3 and 4 and their losses agree."""
    jmodel = JaxFlexible(**ENC)
    opt = jtrain.make_optimizer("Adam", 5e-3, 250, 0.1)
    jstate = jtrain.create_train_state(jmodel, jmodel, opt, jax.random.PRNGKey(0))
    js, ts = _settings()
    batches = [_batch(20 + i) for i in range(4)]
    jstate, first = _jax_steps(jmodel, jstate, js, batches[:2], opt)
    path = str(tmp_path / "checkpoint00002.ckpt")
    jax_export(path, 2, jax.tree.map(np.asarray, jstate.params_coarse),
               jax.tree.map(np.asarray, jstate.params_fine), first[-1], 0.0,
               opt_state=jstate.opt_state)
    _, want = _jax_steps(jmodel, jstate, js, batches[2:], opt)

    spec = ttrain.make_optimizer("Adam", 5e-3, 250, 0.1)
    tstate = ttrain.create_train_state(FlexibleNeRFModel(**ENC), FlexibleNeRFModel(**ENC), spec)
    info = load_train_checkpoint(path, tstate.model_coarse, tstate.model_fine, tstate.optimizer)
    assert info == {"step": 2, "count": 2, "moments": True}
    tstate.step = info["step"]
    tstate.scheduler = spec.make_scheduler(tstate.optimizer, info["count"])
    assert tstate.optimizer.param_groups[0]["lr"] == pytest.approx(
        float(jtrain.exponential_lr_schedule(5e-3, 250, 0.1)(2)), rel=1e-6)
    tstate, got = _port_steps(tstate, ts, batches[2:])
    np.testing.assert_allclose(got, want, rtol=2e-3)

    # The port's own checkpoint round-trips its Adam state.
    out = str(tmp_path / "checkpoint00004.ckpt")
    export_reference_checkpoint(out, tstate.step, tstate.model_coarse, tstate.model_fine,
                                got[-1], 0.0, tstate.optimizer, hwf=(8, 8, 10.0))
    assert latest_checkpoint(str(tmp_path)) == out
    again = ttrain.create_train_state(FlexibleNeRFModel(**ENC), FlexibleNeRFModel(**ENC), spec)
    assert load_train_checkpoint(out, again.model_coarse, again.model_fine,
                                 again.optimizer) == {"step": 4, "count": 4, "moments": True}
    for a, b in zip(again.params, tstate.params):
        assert torch.equal(a.detach(), b.detach())
    for i, p in enumerate(tstate.params):
        ref = tstate.optimizer.state[p]
        res = again.optimizer.state[again.params[i]]
        assert torch.equal(ref["exp_avg"], res["exp_avg"])


def test_weights_only_checkpoint_restarts_the_optimizer(tmp_path):
    jmodel, pc, pf, _, _ = _flagship()
    path = str(tmp_path / "w.ckpt")
    jax_export(path, 7, jax.tree.map(np.asarray, pc), jax.tree.map(np.asarray, pf), 0.1, 10.0)
    state = ttrain.create_train_state(FlexibleNeRFModel(**ENC), FlexibleNeRFModel(**ENC),
                                      ttrain.make_optimizer("Adam", 5e-3))
    info = load_train_checkpoint(path, state.model_coarse, state.model_fine, state.optimizer)
    assert info == {"step": 7, "count": 0, "moments": False}
    np.testing.assert_array_equal(state.model_fine.layer1.weight.detach().numpy(),
                                  np.asarray(pf["layer1"]["kernel"]).T)
    # A weights-only .ntc (convert_checkpoint.py's) restarts the optimizer too.
    ntc = str(tmp_path / "w.ntc")
    save_checkpoint(ntc, {"step": 7, "params_coarse": jax.tree.map(np.asarray, pc),
                          "params_fine": jax.tree.map(np.asarray, pf)})
    spec = ttrain.make_optimizer("Adam", 5e-3)
    state = ttrain.create_train_state(FlexibleNeRFModel(**ENC), FlexibleNeRFModel(**ENC), spec)
    info = load_train_checkpoint(ntc, state.model_coarse, state.model_fine, state.optimizer, spec)
    assert info == {"step": 7, "count": 0, "moments": False}
    np.testing.assert_array_equal(state.model_coarse.fc_rgb.weight.detach().numpy(),
                                  np.asarray(pc["fc_rgb"]["kernel"]).T)


def test_train_loop_is_deterministic_whatever_the_steps_per_call():
    store = [torch.from_numpy(a) for a in _batch(30, n=64)]
    losses = {}
    for k in (1, 3):
        state, settings = _narrow_state()
        settings = dataclasses.replace(settings, perturb=True, radiance_field_noise_std=0.5)
        loop = ttrain.make_train_loop(state.model_coarse, None, settings, 8, k)
        trace = []
        for _ in range(3 // k):
            state, m = loop(state, *store, 42)
            assert m.loss.shape == (k,)
            trace += m.loss.tolist()
        losses[k] = trace
    assert losses[1] == losses[3]


def test_train_loop_spans_each_step_by_phase(tmp_path):
    state, settings = _narrow_state()
    settings = dataclasses.replace(settings, num_fine=4)   # a coarse and a fine evaluation
    loop = ttrain.make_train_loop(state.model_coarse, None, settings, 8, 2)
    store = [torch.from_numpy(a) for a in _batch(30, n=64)]
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        loop(state, *store, 42)
    spans = chrome_spans(prof, tmp_path)
    order = [TRAIN_DRAW, TRAIN_FORWARD, TRAIN_BACKWARD, TRAIN_UPDATE]
    phases = [s for s in spans if s[0] in order]
    assert [s[0] for s in phases] == order * 2
    assert all(a[2] <= b[1] for a, b in zip(phases, phases[1:]))
    fields = [s for s in spans if s[0] == RENDER_FIELD]
    assert len(fields) == 4
    for _, start, end in (s for s in phases if s[0] == TRAIN_FORWARD):
        assert sum(start <= f[1] and f[2] <= end + 1e-3 for f in fields) == 2

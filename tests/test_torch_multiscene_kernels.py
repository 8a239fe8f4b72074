"""The multi-scene training step through the training kernels of
nerf_tpu_torch, #8 (``fused_flex_mlp_train``, 4x128) and #9
(``fused_paper_mlp_train``, 8x256), against the JAX package.

Under ``torch.func.vmap`` over stacked parameters the pair's autograd
function folds the scenes into one scene-batched call each way
(``kernels/train_vjp.py``); on the CPU that call runs the plain pair scene by
scene, as these tests run it, and on the card one launch of the kernels
(tests/test_torch_cuda.py). JAX vmaps its Pallas pair, run here in interpret
mode. Weights come from ``jax.random.PRNGKey(s)`` for scene s through
``load_jax_params``; inputs from numpy seeds. At the kernels' widths, S = 2-3
scenes of a few rays and 8 samples:

- (a) float32: the vmapped pair against ``jax.vmap`` of the JAX
  ``fused_*_train(..., interpret=True)`` and of its gradient: the forward
  and every parameter gradient, scaled by the leaf's largest entry, to the
  single-scene files' tolerances (2e-4 for #8, 5e-4 for #9: the JAX kernels
  make their sinusoids by a double-angle recurrence, the port calls
  sin/cos). ddc enters through the viewdir rows of ``layers_dir.0``, which
  both packages form as ``enc(viewdirs)^T ddc``; (c) holds ddc itself.
- (b) bfloat16 against JAX's XLA autodiff of ``model.apply`` on a bf16
  encoding under ``jax.vmap`` (JAX's CPU backend has no bf16 x bf16 -> f32
  dot, so its interpret kernel cannot run in bf16), by the rule of
  ``test_bf16_matches_jax_xla_autodiff``: the forward to 2e-2, and each
  scene's whole gradient no farther (norm) from JAX's f32 gradient than 1.1
  times JAX's own bf16 path is.
- (c) Each scene's slice of the scene-batched pair is the single-scene pair
  on that scene, bitwise (output, residuals, gradient, ddc); ddc is the
  gradient of the plain forward in dc by autograd to 1e-5 of its largest
  entry; through autograd, the vmapped evaluation (viewdirs and points
  batched or not) gives each scene what ``fused_*_train`` gives its model
  alone, gradients to 1e-6 of each leaf's largest (the host matmul of dc
  runs batched).
- (d) ``make_multiscene_train_step`` with ``use_pallas_train`` against the
  JAX ``make_multiscene_train_step`` with the same settings (``jit=False``)
  reaching its Pallas pair in interpret mode, on JAX's per-scene draws
  injected: one scene-batched forward and backward call a field
  evaluation, losses over two Adam steps to rtol 2e-3 (the JAX package's
  trajectory tolerance) and the first step's gradients to the kernel's
  tolerance of (a) against ``jax.vmap(jax.value_and_grad)`` of JAX's loss.
- (e) ``use_pallas`` alone trains the plain field: the step is bitwise the
  step without it, and no kernel is called, as JAX's ``make_loss_fn``
  turns it off.
- (f) Gradients reach every stacked leaf of every scene (#9's dead
  ``layers_dir.3`` excepted, zero as in JAX), and a scene's losses and
  weights do not depend on the other scenes (rtol 1e-6, atol 1e-6, as the
  plain step's test).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

import nerf_tpu.ops.pallas.flex_train as jft
import nerf_tpu.ops.pallas.paper_train as jpt
from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine import train as jtrain
from nerf_tpu.engine.checkpoint import to_torch_state_dict
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.models import PaperNeRFModel as JaxPaper
from nerf_tpu.parallel import multiscene as jms
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, load_jax_params
from nerf_tpu_torch.kernels import flex_train as tft
from nerf_tpu_torch.kernels import mlp_t as tmlp_t
from nerf_tpu_torch.kernels import paper_train as tpt
from nerf_tpu_torch.models import FlexibleNeRFModel, PaperNeRFModel
from nerf_tpu_torch.parallel import multiscene as tms

torch.set_num_threads(1)
ENC = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)


@dataclasses.dataclass(frozen=True)
class Family:
    name: str
    jax_model: type
    model: type
    jax_module: object          # the JAX module holding the Pallas pair
    fn: str                     # the pair's name in both packages
    port: object                # the port's kernel module
    prefix: str                 # the port's wrapper names: <prefix>_fwd_scenes, ...
    tol: float                  # f32 forward and scaled gradients vs the interpret kernel
    static: tuple               # the port wrappers' trailing arguments

    def jax_train(self, params, pts, vd):
        kw = {"num_freq_xyz": 10} if self.name == "paper" else {}
        return getattr(self.jax_module, self.fn)(params, pts, vd, interpret=True, **kw)

    def train_fn(self):
        return getattr(self.port, self.fn)

    def wrapper(self, which):
        return getattr(self.port, f"{self.prefix}_{which}")


FAMILIES = {
    "flex": Family("flex", JaxFlexible, FlexibleNeRFModel, jft, "fused_flex_mlp_train", tft,
                   "flex_train", 2e-4, ()),
    "paper": Family("paper", JaxPaper, PaperNeRFModel, jpt, "fused_paper_mlp_train", tpt,
                    "paper_train", 5e-4, (10,)),
}


def _jax_params(fam, scenes):
    jmodel = fam.jax_model(**ENC)
    return jmodel, [jmodel.init(jax.random.PRNGKey(s)) for s in range(scenes)]


def _stack(trees):
    return jax.tree.map(lambda *x: jnp.stack([jnp.asarray(a) for a in x]), *trees)


def _inputs(scenes, n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (scenes, n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(scenes, n, 3)).astype(np.float32)
    cot = rng.normal(size=(scenes, n, s, 4)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True), cot


class _Field(nn.Module):
    """A model and the training pair: what ``functional_call`` swaps a scene's
    parameters into."""

    def __init__(self, model, fn, compute_dtype):
        super().__init__()
        self.model, self.fn, self.compute_dtype = model, fn, compute_dtype

    def forward(self, pts, vd):
        return self.fn(self.model, pts, vd, self.compute_dtype)


def _stacked_leaves(models):
    names = [k for k, _ in models[0].named_parameters()]
    return {f"model.{k}": torch.stack([dict(m.named_parameters())[k].detach() for m in models])
            .requires_grad_(True) for k in names}


def _grad(leaf):
    """A leaf's gradient; zeros for one the evaluation never reads (#9's
    layers_dir.3), as the trainer's zeroed gradients hold it."""
    return torch.zeros_like(leaf) if leaf.grad is None else leaf.grad


def _port_vmapped(fam, models, pts, vd, cot, compute_dtype):
    """The vmapped pair on stacked leaves: (out (S, N, P, 4), each scene's
    gradients in the JAX layout)."""
    field = _Field(fam.model(**ENC), fam.train_fn(), compute_dtype)
    leaves = _stacked_leaves(models)
    out = torch.func.vmap(lambda p, x, v: torch.func.functional_call(field, p, (x, v)))(
        leaves, pts, vd)
    (out * cot).sum().backward()
    grads = [convert_torch_state_dict({k[len("model."):]: _grad(v)[s] for k, v in leaves.items()})
             for s in range(len(models))]
    return out.detach(), grads


def _leaves(tree, prefix=""):
    """A params pytree (nested dicts and lists) as {dotted name: array}."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_leaves(v, f"{prefix}{k}."))
    return out


def _scene(tree, s):
    return jax.tree.map(lambda x: np.asarray(x)[s], tree)


@pytest.mark.parametrize("name,scenes,n,s", [("flex", 3, 12, 8), ("paper", 2, 8, 8)])
def test_batched_pair_matches_the_vmapped_jax_kernel(name, scenes, n, s):
    fam = FAMILIES[name]
    _, jparams = _jax_params(fam, scenes)
    models = [load_jax_params(fam.model(**ENC), p) for p in jparams]
    pts, vd, cot = _inputs(scenes, n, s, seed=scenes + n)
    stacked = _stack(jparams)
    want = np.asarray(jax.vmap(fam.jax_train)(stacked, jnp.asarray(pts), jnp.asarray(vd)))
    want_grads = jax.vmap(jax.grad(lambda p, x, v, c: jnp.sum(fam.jax_train(p, x, v) * c)))(
        stacked, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(cot))
    got, grads = _port_vmapped(fam, models, *(torch.from_numpy(a) for a in (pts, vd, cot)),
                               "float32")
    assert got.shape == (scenes, n, s, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=fam.tol, atol=fam.tol)
    for sc in range(scenes):
        port, jax_ = _leaves(grads[sc]), _leaves(_scene(want_grads, sc))
        assert port.keys() == jax_.keys()
        for leaf, b in jax_.items():
            a = port[leaf]
            assert a.shape == b.shape, leaf
            if leaf.startswith("layers_dir.3"):       # never run: zero in both
                assert not a.any() and not b.any(), leaf
                continue
            scale = max(np.abs(b).max(), 1e-3)
            np.testing.assert_allclose(a / scale, b / scale, atol=fam.tol,
                                       err_msg=f"scene {sc} {leaf}")


def _jax_autodiff(jmodel, params, pts, vd, cot, dtype):
    """``jax.vmap`` over scenes of XLA autodiff of ``model.apply`` on an
    encoding in ``dtype``: (out (S, N, P, 4), gradients)."""
    settings = jrend.RenderSettings(**ENC)

    def loss(p, x, v, c):
        enc = jrend.encode_points(x, v, settings).astype(dtype)
        out = jmodel.apply(p, enc).astype(jnp.float32)
        return jnp.sum(out * c), out

    (_, out), grads = jax.vmap(jax.value_and_grad(loss, has_aux=True))(
        params, jnp.asarray(pts), jnp.asarray(vd), jnp.asarray(cot))
    return np.asarray(out), grads


@pytest.mark.parametrize("name", ["flex", "paper"])
def test_bf16_batched_pair_matches_jax_xla_autodiff(name):
    fam = FAMILIES[name]
    jmodel, jparams = _jax_params(fam, 2)
    models = [load_jax_params(fam.model(**ENC), p) for p in jparams]
    pts, vd, cot = _inputs(2, 40, 8, seed=4)
    stacked = _stack(jparams)
    want_out, want16 = _jax_autodiff(jmodel, stacked, pts, vd, cot, jnp.bfloat16)
    _, want32 = _jax_autodiff(jmodel, stacked, pts, vd, cot, jnp.float32)
    got, grads = _port_vmapped(fam, models, *(torch.from_numpy(a) for a in (pts, vd, cot)),
                               "bfloat16")
    np.testing.assert_allclose(got.numpy(), want_out, rtol=2e-2, atol=2e-2)
    for sc in range(2):
        port, b16, b32 = (_leaves(t) for t in (grads[sc], _scene(want16, sc),
                                                 _scene(want32, sc)))
        names = [k for k in b32 if not k.startswith("layers_dir.3")]   # zero on every path
        a, j16, j32 = (np.concatenate([t[k].ravel() for k in names]) for t in (port, b16, b32))
        assert np.linalg.norm(a - j32) <= 1.1 * np.linalg.norm(j16 - j32), sc


def _pair_inputs(fam, scenes, n, s, seed):
    """Stacked inputs of the pair: points, dc and packed parameters of
    seeded models, a cotangent."""
    models = [fam.model(**ENC, generator=torch.Generator().manual_seed(seed + i))
              for i in range(scenes)]
    pts, vd, cot = (torch.from_numpy(a) for a in _inputs(scenes, n, s, seed))
    with torch.no_grad():
        dc = torch.stack([fam.port.dir_contribution(m, vd[i]) for i, m in enumerate(models)])
        params = torch.stack([fam.port.pack_params(m) for m in models])
    return models, pts, vd, dc, params, cot


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", ["flex", "paper"])
def test_each_scene_is_the_single_scene_pair(name, compute_dtype):
    fam = FAMILIES[name]
    scenes, n, s = 3, 5, 7
    models, pts, vd, dc, params, cot = _pair_inputs(fam, scenes, n, s, seed=11)
    out, res = fam.wrapper("fwd_scenes")(pts, dc, params, compute_dtype, *fam.static)
    grad, ddc = fam.wrapper("bwd_scenes")(cot, res, params, compute_dtype, *fam.static)
    assert out.shape == (scenes, n, s, 4) and grad.shape == params.shape
    assert ddc.shape == dc.shape
    plain_fwd = fam.wrapper("plain_fwd")
    for i in range(scenes):
        o1, r1 = fam.wrapper("fwd")(pts[i], dc[i], params[i], compute_dtype, *fam.static)
        g1, d1 = fam.wrapper("bwd")(cot[i], r1, params[i], n, s, compute_dtype, *fam.static)
        assert torch.equal(out[i], o1) and torch.equal(grad[i], g1) and torch.equal(ddc[i], d1)
        assert all(torch.equal(a, b) for a, b in zip(res[i], r1))
        if compute_dtype == "float32":
            dc_i = dc[i].clone().requires_grad_(True)
            want = torch.autograd.grad((plain_fwd(pts[i], dc_i, params[i], "float32",
                                                  *fam.static)[0] * cot[i]).sum(), dc_i)[0]
            scale = float(want.abs().max())
            torch.testing.assert_close(ddc[i] / scale, want / scale, rtol=0, atol=1e-5)


@pytest.mark.parametrize("batched", [True, False], ids=["own_rays", "shared_rays"])
@pytest.mark.parametrize("name", ["flex", "paper"])
def test_vmapped_evaluation_gives_each_scene_its_own(name, batched):
    """Through autograd: each scene of the vmapped evaluation against
    ``fused_*_train`` on its model alone; with ``shared_rays`` the points and
    view directions are unbatched (in_dims None) and every scene reads
    them."""
    fam = FAMILIES[name]
    models, pts, vd, _, _, cot = _pair_inputs(fam, 3, 6, 5, seed=21)
    if not batched:
        pts, vd = pts[0], vd[0]
    dims = (0, 0, 0) if batched else (0, None, None)
    calls = []
    real = fam.wrapper("plain_fwd")
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(fam.port, f"{fam.prefix}_plain_fwd",
                   lambda *a, **k: calls.append(1) or real(*a, **k))
        field = _Field(fam.model(**ENC), fam.train_fn(), "float32")
        leaves = _stacked_leaves(models)
        out = torch.func.vmap(lambda p, x, v: torch.func.functional_call(field, p, (x, v)),
                              in_dims=dims)(leaves, pts, vd)
        (out * cot).sum().backward()
    assert len(calls) == 3                 # one scene-batched call: the plain pair a scene
    for i, model in enumerate(models):
        x, v = (pts[i], vd[i]) if batched else (pts, vd)
        want = fam.train_fn()(model, x, v)
        (want * cot[i]).sum().backward()
        torch.testing.assert_close(out[i], want.detach(), rtol=1e-6, atol=1e-6)
        for k, p in model.named_parameters():
            got = _grad(leaves[f"model.{k}"])[i]
            if p.grad is None:             # #9's dead layers_dir.3
                assert not got.any(), k
                continue
            scale = max(float(p.grad.abs().max()), 1e-3)
            torch.testing.assert_close(got / scale, p.grad / scale, rtol=0, atol=1e-6, msg=k)


def test_scene_wrappers_raise_instead_of_falling_back():
    fam = FAMILIES["flex"]
    meta = torch.device("meta")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tft.flex_train_fwd_scenes(torch.zeros(2, 3, 4, 3, device=meta),
                                  torch.zeros(2, 3, 64, device=meta),
                                  torch.zeros(2, 82820, device=meta))
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tpt.paper_train_bwd_scenes(torch.zeros(2, 3, 4, 4, device=meta),
                                   (torch.zeros(2, 1, device=meta),),
                                   torch.zeros(2, 10, device=meta), "float32", 10)
    with pytest.raises(ValueError, match="compute_dtype"):
        fam.train_fn()(FlexibleNeRFModel(**ENC), torch.zeros(2, 4, 3), torch.ones(2, 3),
                       "float16")


# --- the multi-scene step --------------------------------------------------

S, B, NC, NF = 2, 4, 4, 4


def _settings(**kw):
    base = dict(num_coarse=NC, num_fine=NF, perturb=True, radiance_field_noise_std=0.2,
                white_background=True, near=2.0, far=6.0, **ENC)
    base.update(kw)
    return jrend.RenderSettings(**base), trend.RenderSettings(**base)


def _batches(seed, steps):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(steps):
        ro = (rng.uniform(-0.3, 0.3, (S, B, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
        rd = (rng.normal(size=(S, B, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
        out.append((ro, rd, rng.uniform(0, 1, (S, B, 3)).astype(np.float32)))
    return out


def _jax_draws(key):
    """The numbers JAX's vmapped step draws for each scene, stacked."""
    fields = [[], [], [], []]
    for k in jax.random.split(key, S):
        kp, knc, kf, knf = jax.random.split(k, 4)
        fields[0].append(jax.random.uniform(kp, (B, NC)))
        fields[1].append(jax.random.normal(knc, (B, NC)))
        fields[2].append(jax.random.uniform(kf, (B, NF)))
        fields[3].append(jax.random.normal(knf, (B, NC + NF)))
    return trend.RenderDraws(*(torch.from_numpy(np.stack([np.asarray(x) for x in f]))
                               for f in fields))


def _port_state(fam, jstate, spec):
    tmodel = fam.model(**ENC)
    state = tms.create_multiscene_state(tmodel, tmodel, spec, 0, S)
    with torch.no_grad():
        for which, tree in (("coarse", jstate.params_coarse), ("fine", jstate.params_fine)):
            for s in range(S):
                for k, v in to_torch_state_dict(_scene(tree, s)).items():
                    state.params[f"{which}.{k}"][s].copy_(torch.from_numpy(v))
    return tmodel, state


@pytest.fixture
def counted_calls(monkeypatch):
    """Reach the JAX package's training pairs here, in interpret mode (its
    renderer takes them only on a TPU), and count the calls of the JAX pairs
    and of the port's scene-batched wrappers (one a field evaluation)."""
    calls = {"jax": 0, "port_fwd": 0, "port_bwd": 0}
    for fam in FAMILIES.values():
        real = getattr(fam.jax_module, fam.fn)

        def interpret(*args, _real=real, **kwargs):
            calls["jax"] += 1
            return _real(*args, **{**kwargs, "interpret": True})

        monkeypatch.setattr(fam.jax_module, fam.fn, interpret)
        for which, key in (("forward_scenes", "port_fwd"), ("backward_scenes", "port_bwd")):
            real_port = getattr(fam.port, f"plain_{which}")

            def counted(*args, _real=real_port, _key=key):
                calls[_key] += 1
                return _real(*args)

            monkeypatch.setattr(fam.port, f"plain_{which}", counted)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return calls


@pytest.mark.parametrize("name", ["flex", "paper"])
def test_kernel_multiscene_step_matches_jax(name, counted_calls):
    fam = FAMILIES[name]
    jmodel = fam.jax_model(**ENC)
    opt = jtrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    jstate = jms.create_multiscene_state(jmodel, jmodel, opt, jax.random.PRNGKey(0), S)
    spec = ttrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    tmodel, state = _port_state(fam, jstate, spec)
    js, ts = _settings(use_pallas_train=True)
    loss_fn = jtrain.make_loss_fn(jmodel, jmodel, js)
    jstep = jms.make_multiscene_train_step(jmodel, jmodel, js, opt, jit=False)
    tstep = tms.make_multiscene_train_step(tmodel, tmodel, ts)
    for i, (ro, rd, tgt) in enumerate(_batches(1, 2)):
        key = jax.random.PRNGKey(100 + i)
        if i == 0:
            trainable = {"coarse": jstate.params_coarse, "fine": jstate.params_fine}
            _, want_grads = jax.vmap(jax.value_and_grad(loss_fn, has_aux=True))(
                trainable, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt),
                jax.random.split(key, S))
        before = dict(counted_calls)
        jstate, jm = jstep(jstate, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt), key)
        state, tm = tstep(state, torch.from_numpy(ro), torch.from_numpy(rd),
                          torch.from_numpy(tgt), draws=_jax_draws(key))
        # Coarse and fine: the JAX pair traced once each under its vmap; the
        # port's one scene-batched call each way for all S scenes.
        assert {k: counted_calls[k] - before[k] for k in before} == {
            "jax": 2, "port_fwd": 2, "port_bwd": 2}
        for got, want in zip(tm, jm):
            assert got.shape == (S,)
            np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-3)
        if i == 0:
            for which in ("coarse", "fine"):
                for s in range(S):
                    port = _leaves(convert_torch_state_dict(
                        {k[len(which) + 1:]: v.grad[s] for k, v in state.params.items()
                         if k.startswith(which + ".")}))
                    jax_ = _leaves(_scene(want_grads[which], s))
                    for leaf, b in jax_.items():
                        scale = max(np.abs(b).max(), 1e-3)
                        np.testing.assert_allclose(port[leaf] / scale, b / scale,
                                                   atol=fam.tol,
                                                   err_msg=f"{which} scene {s} {leaf}")
    assert state.step == 2 and int(jstate.step[0]) == 2


def test_use_pallas_alone_gives_the_plain_step():
    spec = ttrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    model = FlexibleNeRFModel(**ENC)
    draws = _jax_draws(jax.random.PRNGKey(3))
    ro, rd, tgt = (torch.from_numpy(a) for a in _batches(2, 1)[0])
    runs = []
    calls = []
    real_pair, real_forward = tft.flex_train_plain_fwd, tmlp_t.mlp_t_plain
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tft, "flex_train_plain_fwd",
                   lambda *a, **k: calls.append(1) or real_pair(*a, **k))
        mp.setattr(tmlp_t, "mlp_t_plain", lambda *a, **k: calls.append(1) or real_forward(*a, **k))
        for flags in ({}, {"use_pallas": True}):
            _, ts = _settings(**flags)
            state = tms.create_multiscene_state(model, model, spec, 0, S)
            state, m = tms.make_multiscene_train_step(model, model, ts)(state, ro, rd, tgt,
                                                                        draws=draws)
            runs.append((m.loss, {k: (v.detach().clone(), v.grad.clone())
                                  for k, v in state.params.items()}))
    assert not calls
    assert torch.equal(runs[0][0], runs[1][0])
    for k, (p, g) in runs[0][1].items():
        assert torch.equal(p, runs[1][1][k][0]) and torch.equal(g, runs[1][1][k][1]), k


def _store(seed, scenes, n=40):
    rng = np.random.default_rng(seed)
    ro = (rng.uniform(-0.3, 0.3, (scenes, n, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = (rng.normal(size=(scenes, n, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    return tuple(torch.from_numpy(a) for a in (ro, rd, rng.uniform(0, 1, (scenes, n, 3))
                                                .astype(np.float32)))


@pytest.mark.parametrize("name", ["flex", "paper"])
def test_gradients_reach_every_leaf_and_scenes_are_independent(name):
    fam = FAMILIES[name]
    _, ts = _settings(use_pallas_train=True)
    spec = ttrain.make_optimizer("adam", 5e-3, 250.0, 0.1)
    model = fam.model(**ENC)
    three = _store(3, 3)
    alone = tuple(x[:1] for x in three)
    other = tuple(torch.cat([x[:1], y[1:]]) for x, y in zip(three, _store(4, 3)))
    runs = []
    for store in (alone, three, other):
        state = tms.create_multiscene_state(model, model, spec, 0, store[0].shape[0])
        loop = tms.make_multiscene_train_loop(model, model, ts, B, 2)
        state, m = loop(state, *store, 5)
        if store is three:
            for k, v in state.params.items():
                for s in range(3):
                    dead = k.split(".", 1)[1].startswith("layers_dir.3")
                    assert bool(v.grad[s].any()) != dead, (k, s)
        runs.append((m.loss[:, 0], state.scene_params(0, "coarse"),
                     state.scene_params(0, "fine")))
    for losses, coarse, fine in runs[1:]:
        np.testing.assert_allclose(losses.numpy(), runs[0][0].numpy(), rtol=1e-6)
        for got, want in ((coarse, runs[0][1]), (fine, runs[0][2])):
            for k, v in got.items():
                np.testing.assert_allclose(v.numpy(), want[k].numpy(), rtol=0, atol=1e-6,
                                           err_msg=k)

"""The seven optimizer names of nerf_tpu_torch.engine.optimizers against optax.

- Each name's updates over 5 steps, with and without the exponential
  schedule (rprop ignores it, as the JAX package does), against the JAX
  package's ``make_optimizer`` compiled as its trainer compiles it, on the
  same gradients: parameters to rtol 1e-6.
- The names the JAX package refuses (``asgd``, ``lbfgs``, ``sparseadam``)
  and a misspelt name raise its ``ValueError`` with its message, hint
  included.
- ``.ntc`` checkpoints: the port's optax state has the JAX state's nesting
  and leaf shapes for every name, with and without clipping and schedule;
  a state JAX wrote after 3 updates resumes in the port, and the next 2
  updates agree with JAX's to rtol 1e-6; the port's own state round-trips.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.engine import train as jtrain
from nerf_tpu.engine.checkpoint import _tuples_to_lists
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import (
    _leaves,
    convert_torch_state_dict,
    load_jax_params,
    load_train_checkpoint,
    ntc_train_state,
    save_checkpoint,
    to_torch_state_dict,
)
from nerf_tpu_torch.engine.optimizers import OPTAX_RULES
from nerf_tpu_torch.models import FlexibleNeRFModel

torch.set_num_threads(1)
NAMES = tuple(OPTAX_RULES)
NARROW = dict(num_layers=2, hidden_size=16, skip_connect_every=3, num_encoding_fn_xyz=2,
              num_encoding_fn_dir=1)
RTOL = 1e-6


def _toy(steps):
    rng = np.random.default_rng(0)
    params = {"a": rng.normal(size=(3, 4)).astype(np.float32),
              "b": rng.normal(size=(5,)).astype(np.float32)}
    grads = [{k: (3.0 * rng.normal(size=v.shape)).astype(np.float32) for k, v in params.items()}
             for _ in range(steps)]
    return params, grads


@pytest.mark.parametrize("decay", [None, (0.002, 0.1)], ids=["constant", "exponential"])
@pytest.mark.parametrize("name", NAMES)
def test_optimizer_matches_optax_over_five_steps(name, decay):
    decay = decay or (None, None)
    params, grads = _toy(5)
    jopt = jtrain.make_optimizer(name, 5e-3, *decay)
    update = jax.jit(jopt.update)
    jparams = {k: jnp.asarray(v) for k, v in params.items()}
    jstate = jopt.init(jparams)
    tparams = [torch.nn.Parameter(torch.from_numpy(params[k].copy())) for k in ("a", "b")]
    opt, sched = ttrain.make_optimizer(name, 5e-3, *decay).init(tparams)
    assert isinstance(opt, OPTAX_RULES[name])
    for g in grads:
        updates, jstate = update({k: jnp.asarray(v) for k, v in g.items()}, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        for p, k in zip(tparams, ("a", "b")):
            p.grad = torch.from_numpy(g[k].copy())
        opt.step()
        sched.step()
        for p, k in zip(tparams, ("a", "b")):
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(jparams[k]),
                                       rtol=RTOL, atol=0)
    moved = np.abs(tparams[0].detach().numpy() - params["a"]).max()
    assert moved > 1e-5


@pytest.mark.parametrize("bad", ["asgd", "LBFGS", "SparseAdam", "rmsprob", "adamm", "nope"])
def test_refusals_match_jax(bad):
    with pytest.raises(ValueError) as want:
        jtrain.make_optimizer(bad, 1e-3)
    with pytest.raises(ValueError) as got:
        ttrain.make_optimizer(bad, 1e-3)
    assert str(got.value) == str(want.value)
    assert "Unsupported optimizer" in str(got.value)


def test_every_jax_name_builds():
    names = ("Adam", "AdamW", "SGD", "RMSprop", "Adagrad", "Adamax", "Adadelta", "NAdam",
             "RAdam", "Rprop")
    for name in names:
        jtrain.make_optimizer(name, 1e-3)
        spec = ttrain.make_optimizer(name, 1e-3)
        opt, _ = spec.init([torch.nn.Parameter(torch.zeros(2))])
        assert isinstance(opt, torch.optim.Optimizer)


def _narrow_models(seed=0):
    jmodel = JaxFlexible(**NARROW)
    pc = jmodel.init(jax.random.PRNGKey(seed))
    pf = jmodel.init(jax.random.PRNGKey(seed + 1))
    return jmodel, pc, pf


def _grad_trees(pc, pf, steps, seed=3):
    rng = np.random.default_rng(seed)
    return [jax.tree.map(lambda x: (rng.normal(size=np.shape(x)) * 0.5).astype(np.float32),
                         {"coarse": pc, "fine": pf}) for _ in range(steps)]


@pytest.mark.parametrize("clip", [None, 1.0], ids=["noclip", "clip"])
@pytest.mark.parametrize("decay", [None, (250, 0.1)], ids=["constant", "exponential"])
@pytest.mark.parametrize("name", NAMES)
def test_ntc_state_layout_matches_optax(name, decay, clip):
    decay = decay or (None, None)
    _, pc, pf = _narrow_models()
    jstate = jtrain.make_optimizer(name, 5e-3, *decay, grad_clip_norm=clip).init(
        {"coarse": pc, "fine": pf})
    want = _tuples_to_lists(jax.device_get(jstate))
    spec = ttrain.make_optimizer(name, 5e-3, *decay, grad_clip_norm=clip)
    tc = load_jax_params(FlexibleNeRFModel(**NARROW), pc)
    tf = load_jax_params(FlexibleNeRFModel(**NARROW), pf)
    state = ttrain.create_train_state(tc, tf, spec)
    got = ntc_train_state(0, tc, tf, state.optimizer, spec, 0, 0.0, 0.0)["opt_state"]

    def shape_tree(t):
        if isinstance(t, list):
            return [shape_tree(v) for v in t]
        return np.shape(t)

    assert shape_tree(got) == shape_tree(want)
    # Before any update each slot holds optax's initial value.
    for a, b in zip(_leaves(got), _leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("name", NAMES)
def test_jax_state_resumes_in_the_port(name, tmp_path):
    jmodel, pc, pf = _narrow_models()
    jopt = jtrain.make_optimizer(name, 5e-3, 0.002, 0.1)
    update = jax.jit(jopt.update)
    trainable = {"coarse": pc, "fine": pf}
    jstate = jopt.init(trainable)
    grads = _grad_trees(pc, pf, 5)
    for g in grads[:3]:
        u, jstate = update(g, jstate, trainable)
        trainable = optax.apply_updates(trainable, u)
    ckpt = {"step": np.asarray(3),
            "params_coarse": jax.tree.map(np.asarray, trainable["coarse"]),
            "params_fine": jax.tree.map(np.asarray, trainable["fine"]),
            "opt_state": _tuples_to_lists(jax.device_get(jstate))}

    spec = ttrain.make_optimizer(name, 5e-3, 0.002, 0.1)
    tc, tf = FlexibleNeRFModel(**NARROW), FlexibleNeRFModel(**NARROW)
    state = ttrain.create_train_state(tc, tf, spec)
    path = str(tmp_path / "ckpt.ntc")
    save_checkpoint(path, ckpt)
    info = load_train_checkpoint(path, tc, tf, state.optimizer, spec)
    # rprop keeps no count and its rate is fixed: nothing to position.
    assert (info["step"], info["moments"], info["count"]) == (3, True, 0 if name == "rprop" else 3)
    state.scheduler = spec.make_scheduler(state.optimizer, info["count"])

    for g in grads[3:]:
        u, jstate = update(g, jstate, trainable)
        trainable = optax.apply_updates(trainable, u)
        for model, which in ((tc, "coarse"), (tf, "fine")):
            sd = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in
                  _torch_layout(g[which]).items()}
            for k, p in model.named_parameters():
                p.grad = sd[k].clone()
        state.optimizer.step()
        state.scheduler.step()
    for model, which in ((tc, "coarse"), (tf, "fine")):
        got = convert_torch_state_dict(model.state_dict())
        for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(trainable[which])):
            np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL, atol=1e-7)


def _torch_layout(tree):
    return to_torch_state_dict(jax.tree.map(np.asarray, tree))


@pytest.mark.parametrize("name", NAMES)
def test_port_state_round_trips(name, tmp_path):
    """3 updates, save the ``.ntc`` state, restore into fresh modules, 2 more:
    bitwise the uninterrupted run."""
    spec = ttrain.make_optimizer(name, 5e-3, 0.002, 0.1)
    _, pc, pf = _narrow_models()
    grads = _grad_trees(pc, pf, 5, seed=7)

    def run(models, state, gs):
        for g in gs:
            for model, which in zip(models, ("coarse", "fine")):
                sd = _torch_layout(g[which])
                for k, p in model.named_parameters():
                    p.grad = torch.from_numpy(np.ascontiguousarray(sd[k])).clone()
            state.optimizer.step()
            state.scheduler.step()

    a = [load_jax_params(FlexibleNeRFModel(**NARROW), pc),
         load_jax_params(FlexibleNeRFModel(**NARROW), pf)]
    sa = ttrain.create_train_state(*a, spec)
    run(a, sa, grads[:3])
    path = str(tmp_path / "c.ntc")
    save_checkpoint(path, ntc_train_state(3, *a, sa.optimizer, spec, 3, 0.0, 0.0))
    b = [FlexibleNeRFModel(**NARROW), FlexibleNeRFModel(**NARROW)]
    sb = ttrain.create_train_state(*b, spec)
    info = load_train_checkpoint(path, *b, sb.optimizer, spec)
    sb.scheduler = spec.make_scheduler(sb.optimizer, info["count"])
    run(a, sa, grads[3:])
    run(b, sb, grads[3:])
    for pa, pb in zip(sa.params, sb.params):
        assert torch.equal(pa, pb)

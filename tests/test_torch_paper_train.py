"""The PaperNeRF training pair of nerf_tpu_torch against the JAX one.

On the CPU ``fused_paper_mlp_train`` runs its plain pair
(``paper_train_plain_fwd`` / ``paper_train_plain_bwd``, the hand-derived
backward); here it is held against ``nerf_tpu.ops.pallas.paper_train
.fused_paper_mlp_train`` run in Pallas interpret mode, as
``tests/test_pallas_paper_train.py`` runs it, and against JAX's XLA autodiff
of ``PaperNeRFModel.apply``, on the same weights (``load_jax_params``) and
numpy inputs, at 10 encoding frequencies (``configs/lego_paper.yml``):

- float32 forward to 5e-4 against the interpret kernel (its double-angle
  recurrence sinusoids; tests/test_torch_paper.py) and every one of the 30
  parameter gradients under a random cotangent to a scaled atol of 5e-4, the
  same gap carried back; against XLA autodiff (sin/cos both) to 2e-5;
- ``layers_dir.3`` gets a zero gradient (the JAX kernel's
  ``_assemble_grads`` gives zeros) and pts and viewdirs none;
- the plain pair against torch autograd of ``PaperNeRFModel.forward`` to
  1e-5;
- bfloat16: JAX's CPU backend has no bf16 x bf16 -> f32 dot, so the
  interpret kernel cannot run in bf16 here, and the port is held against
  JAX's bf16 XLA autodiff by the rule of tests/test_torch_flex_train.py:
  forward to 2e-2, and each gradient leaf no farther (norm) from JAX's f32
  gradient than 1.1 times JAX's own bf16 path is. Both bf16 paths are noisy
  estimates of the f32 gradient: at 512 and 1024 points the port is the
  closer at every leaf (at most 0.93 times JAX's distance), while at 320
  points single leaves whose two distances are both 1-2% go either way (up
  to 1.7 times, layers_dir.2's kernel at seed 4). So the per-leaf rule runs
  at the larger inputs, and the whole gradient (every leaf at once) is held
  by the same rule at all three;
- three training steps of the port against three of the JAX package, plain
  path and training kernels, losses within rtol 2e-3 (the JAX package's
  trajectory tolerance), and ``train_nerf`` / ``eval_nerf`` end to end on a
  tiny Paper config.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine import train as jtrain
from nerf_tpu.models import PaperNeRFModel as JaxPaper
from nerf_tpu.ops.pallas.paper_train import fused_paper_mlp_train as jax_paper_train
from nerf_tpu_torch import eval_nerf, train_nerf
from nerf_tpu_torch.config import load_config
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine import train as ttrain
from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, load_jax_params
from nerf_tpu_torch.kernels import paper_train as tpt
from nerf_tpu_torch.kernels.paper_t import images, num_params, pack_params, unpack_params
from nerf_tpu_torch.kernels.paper_train import fused_paper_mlp_train
from nerf_tpu_torch.models import PaperNeRFModel

torch.set_num_threads(1)
ENC = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
LEAVES = [f"{layer}.{leaf}"
          for layer in ([f"layers_xyz.{i}" for i in range(8)] + ["fc_feat", "fc_alpha"]
                        + [f"layers_dir.{i}" for i in range(4)] + ["fc_rgb"])
          for leaf in ("kernel", "bias")]


@pytest.fixture(scope="module")
def paper():
    jmodel = JaxPaper(**ENC)
    params = jmodel.init(jax.random.PRNGKey(0))
    return jmodel, params, load_jax_params(PaperNeRFModel(**ENC), params)


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, s, 4)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True), cot


def _leaf(tree, name):
    layer, leaf = name.rsplit(".", 1)
    if "." in layer:
        base, i = layer.split(".")
        return np.asarray(tree[base][int(i)][leaf])
    return np.asarray(tree[layer][leaf])


def _port_grads(tmodel, pts, vd, cot, compute_dtype):
    """The port's gradients through fused_paper_mlp_train, in the JAX layout;
    gradients start as zeros, as the trainer's create_train_state sets them."""
    for p in tmodel.parameters():
        p.grad = torch.zeros_like(p)
    out = fused_paper_mlp_train(tmodel, torch.from_numpy(pts), torch.from_numpy(vd),
                                compute_dtype)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), convert_torch_state_dict(
        {k: p.grad for k, p in tmodel.named_parameters()})


@pytest.mark.parametrize("n,s", [(33, 8), (140, 12)])
def test_forward_matches_the_jax_kernel(paper, n, s):
    _, params, tmodel = paper
    pts, vd, _ = _inputs(n, s, seed=n + s)
    want = np.asarray(jax_paper_train(params, jnp.asarray(pts), jnp.asarray(vd),
                                      num_freq_xyz=10, interpret=True))
    before = (fused_paper_mlp_train.fwd_launches, fused_paper_mlp_train.bwd_launches)
    with torch.no_grad():
        got = fused_paper_mlp_train(tmodel, torch.from_numpy(pts), torch.from_numpy(vd))
    assert (fused_paper_mlp_train.fwd_launches, fused_paper_mlp_train.bwd_launches) == before
    assert got.shape == (n, s, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


@pytest.fixture(scope="module")
def grads_f32(paper):
    """The port's and the JAX kernel's parameter gradients at n=65 (not a
    multiple of the JAX kernel's 128-ray tile), s=8, one random cotangent."""
    _, params, tmodel = paper
    pts, vd, cot = _inputs(65, 8, seed=0)
    want = jax.grad(lambda p: jnp.sum(jax_paper_train(
        p, jnp.asarray(pts), jnp.asarray(vd), num_freq_xyz=10, interpret=True) * cot))(params)
    _, got = _port_grads(tmodel, pts, vd, cot, "float32")
    return got, want


@pytest.mark.parametrize("leaf", LEAVES)
def test_param_grads_match_the_jax_kernel(grads_f32, leaf):
    got, want = (_leaf(tree, leaf) for tree in grads_f32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=5e-4, err_msg=leaf)


def test_dead_layer_gets_a_zero_gradient(grads_f32):
    got, want = grads_f32
    for leaf in ("layers_dir.3.kernel", "layers_dir.3.bias"):
        assert not np.any(_leaf(got, leaf)) and not np.any(_leaf(want, leaf))


def _jax_autodiff(jmodel, params, pts, vd, cot, dtype):
    settings = jrend.RenderSettings(**ENC)

    def loss(p):
        enc = jrend.encode_points(jnp.asarray(pts), jnp.asarray(vd), settings).astype(dtype)
        out = jmodel.apply(p, enc).astype(jnp.float32)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), grads


def test_grads_match_xla_autodiff(paper):
    jmodel, params, tmodel = paper
    pts, vd, cot = _inputs(40, 8, seed=2)
    want_out, want = _jax_autodiff(jmodel, params, pts, vd, cot, jnp.float32)
    got_out, got = _port_grads(tmodel, pts, vd, cot, "float32")
    np.testing.assert_allclose(got_out, want_out, rtol=2e-5, atol=2e-5)
    for leaf in LEAVES:
        a, b = _leaf(got, leaf), _leaf(want, leaf)
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a / scale, b / scale, atol=2e-5, err_msg=leaf)


@pytest.mark.parametrize("n,s,seed,per_leaf", [(64, 16, 1, True), (64, 8, 7, True),
                                                (40, 8, 4, False)])
def test_bf16_matches_jax_xla_autodiff(paper, n, s, seed, per_leaf):
    jmodel, params, tmodel = paper
    pts, vd, cot = _inputs(n, s, seed=seed)
    want_out, want16 = _jax_autodiff(jmodel, params, pts, vd, cot, jnp.bfloat16)
    _, want32 = _jax_autodiff(jmodel, params, pts, vd, cot, jnp.float32)
    got_out, got = _port_grads(tmodel, pts, vd, cot, "bfloat16")
    np.testing.assert_allclose(got_out, want_out, rtol=2e-2, atol=2e-2)
    leaves = [leaf for leaf in LEAVES if not leaf.startswith("layers_dir.3")]  # zero on every path
    if per_leaf:
        for leaf in leaves:
            a, b16, b32 = _leaf(got, leaf), _leaf(want16, leaf), _leaf(want32, leaf)
            norm = np.linalg.norm(b32)
            port, jax_bf16 = np.linalg.norm(a - b32) / norm, np.linalg.norm(b16 - b32) / norm
            assert port <= 1.1 * jax_bf16, (leaf, port, jax_bf16)
    a, b16, b32 = (np.concatenate([_leaf(t, leaf).ravel() for leaf in leaves])
                   for t in (got, want16, want32))
    assert np.linalg.norm(a - b32) <= 1.1 * np.linalg.norm(b16 - b32)


@pytest.mark.parametrize("n,s,f", [(1, 1, 10), (9, 7, 10), (12, 16, 6)])
def test_plain_pair_matches_torch_autograd(n, s, f):
    """The hand-derived backward against autograd of the module, f32."""
    from nerf_tpu_torch.engine.renderer import RenderSettings, encode_points

    model = PaperNeRFModel(num_encoding_fn_xyz=f, generator=torch.Generator().manual_seed(n))
    pts, vd, cot = (torch.from_numpy(a) for a in _inputs(n, s, seed=n * s))
    out = fused_paper_mlp_train(model, pts, vd)
    (out * cot).sum().backward()
    got = {k: p.grad for k, p in model.named_parameters()}
    assert got["layers_dir.3.weight"] is None         # never run: autograd leaves it alone
    model.zero_grad()
    settings = RenderSettings(num_encoding_fn_xyz=f, num_encoding_fn_dir=4)
    want = model(encode_points(pts, vd, settings))
    (want * cot).sum().backward()
    torch.testing.assert_close(out.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    for name, p in model.named_parameters():
        if got[name] is None:
            assert p.grad is None, name
            continue
        scale = max(float(p.grad.abs().max()), 1e-3)
        torch.testing.assert_close(got[name] / scale, p.grad / scale, rtol=0, atol=1e-5,
                                   msg=name)


def test_no_gradient_reaches_pts_or_viewdirs(paper):
    _, _, tmodel = paper
    pts, vd, _ = _inputs(6, 4, seed=3)
    pts, vd = torch.from_numpy(pts).requires_grad_(True), torch.from_numpy(vd).requires_grad_(True)
    fused_paper_mlp_train(tmodel, pts, vd).sum().backward()
    assert pts.grad is None and vd.grad is None
    tmodel.zero_grad()


def test_plain_backward_zeroes_the_layout_pads():
    model = PaperNeRFModel(**ENC)
    pts, vd, cot = (torch.from_numpy(a) for a in _inputs(5, 3, seed=9))
    params = pack_params(model).detach()
    dc = tpt.dir_contribution(model, vd).detach()
    _, res = tpt.paper_train_plain_fwd(pts, dc, params, "float32", 10)
    assert len(res) == 13 and res[0].shape == (15, 63) and res[9].shape == (15, 256)
    grad, ddc = tpt.paper_train_plain_bwd(cot, res, params, 5, 3, "float32", 10)
    assert grad.shape == (num_params(10),) and ddc.shape == (5, 128)
    layers = unpack_params(grad, 10)
    kept = sum(w.numel() + b.numel() for w, b in layers.values())
    assert int((grad != 0).sum()) <= kept and bool(torch.isfinite(grad).all())
    assert float(grad.abs().sum()) == pytest.approx(
        sum(float(w.abs().sum() + b.abs().sum()) for w, b in layers.values()), rel=1e-6)


def test_backward_weights_layout():
    model = PaperNeRFModel(**ENC)
    wt = images(10).f32_backward.pack(pack_params(model).detach())
    assert wt.numel() == 590464
    torch.testing.assert_close(wt[:384].view(3, 128), model.fc_rgb.weight)
    # [layers_dir.0 feat cols; fc_alpha] are contiguous (129, 256) rows: the fused head.
    head = wt[384 + 2 * 16384:384 + 2 * 16384 + 129 * 256].view(129, 256)
    torch.testing.assert_close(head, torch.cat([model.layers_dir[0].weight[:, :256],
                                                model.fc_alpha.weight]))
    # layers_xyz.4 gives its h columns only, after fc_feat and layers_xyz.7..5.
    at = 384 + 2 * 16384 + 129 * 256 + 4 * 65536
    torch.testing.assert_close(wt[at:at + 65536].view(256, 256), model.layers_xyz[4].weight[:, 63:])


def test_wrapper_raises_instead_of_falling_back(paper):
    _, _, tmodel = paper
    pts, vd = torch.zeros(2, 8, 3), torch.ones(2, 3)
    with pytest.raises(ValueError, match="not the shape"):
        fused_paper_mlp_train(PaperNeRFModel(use_viewdirs=False), pts, vd)
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_paper_mlp_train(tmodel, pts, vd, "float16")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tpt.paper_train_fwd(pts.to("meta"), torch.zeros(2, 128, device="meta"),
                            torch.zeros(num_params(10), device="meta"), "float32", 10)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        tpt.paper_train_bwd(torch.zeros(2, 8, 4, device="meta"),
                            (torch.zeros(1, device="meta"),),
                            torch.zeros(num_params(10), device="meta"), 2, 8, "float32", 10)


# --- the slice: training steps and the CLIs --------------------------------


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


@pytest.fixture
def jax_paper_train_on_cpu(monkeypatch):
    """Let the JAX renderer reach its Paper training kernels here, in
    interpret mode."""
    import nerf_tpu.ops.pallas.paper_train as jpt

    real = jpt.fused_paper_mlp_train
    calls = []

    def interpret(*args, **kwargs):
        calls.append(1)
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(jpt, "fused_paper_mlp_train", interpret)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return calls


@pytest.mark.parametrize("kernels", [False, True], ids=["plain", "use_pallas_train"])
def test_train_steps_match_jax(kernels, request):
    calls = request.getfixturevalue("jax_paper_train_on_cpu") if kernels else None
    jmodel = JaxPaper(**ENC)
    opt = jtrain.make_optimizer("Adam", 5e-4, 250, 0.1)
    jstate = jtrain.create_train_state(jmodel, jmodel, opt, jax.random.PRNGKey(0))
    tc = load_jax_params(PaperNeRFModel(**ENC), jax.tree.map(np.asarray, jstate.params_coarse))
    tf = load_jax_params(PaperNeRFModel(**ENC), jax.tree.map(np.asarray, jstate.params_fine))
    tstate = ttrain.create_train_state(tc, tf, ttrain.make_optimizer("Adam", 5e-4, 250, 0.1))
    js, ts = _settings(use_pallas_train=kernels)
    batches = [_batch(10 + i) for i in range(3)]
    step = jtrain.make_train_step(jmodel, jmodel, js, opt, jit=False)
    want = []
    for i, (ro, rd, tgt) in enumerate(batches):
        jstate, m = step(jstate, jnp.asarray(ro), jnp.asarray(rd), jnp.asarray(tgt),
                         jax.random.PRNGKey(i))
        want.append(float(m.loss))
    if kernels:
        assert len(calls) == 6           # coarse + fine, 3 steps
    port_calls = []
    real = tpt.paper_train_plain_bwd
    tstep = ttrain.make_train_step(tc, tf, ts)
    got = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpt, "paper_train_plain_bwd",
                   lambda *a, **k: port_calls.append(1) or real(*a, **k))
        for ro, rd, tgt in batches:
            tstate, m = tstep(tstate, *(torch.from_numpy(a) for a in (ro, rd, tgt)))
            got.append(float(m.loss))
    assert tstate.step == 3 and len(port_calls) == (6 if kernels else 0)
    np.testing.assert_allclose(got, want, rtol=2e-3)


def test_dead_layer_decays_under_adamw_as_in_optax():
    """layers_dir.3 ends a kernel-path step with a zero gradient, not None, so
    AdamW decays it as optax.adamw decays the JAX package's zero-gradient leaf."""
    model = PaperNeRFModel(**ENC, generator=torch.Generator().manual_seed(4))
    state = ttrain.create_train_state(model, None, ttrain.make_optimizer("AdamW", 5e-4))
    _, ts = _settings(use_pallas_train=True, num_fine=0)
    before = model.layers_dir[3].weight.detach().clone()
    ro, rd, tgt = (torch.from_numpy(a) for a in _batch(3, n=8))
    state, _ = ttrain.make_train_step(model, None, ts)(state, ro, rd, tgt)
    assert model.layers_dir[3].weight.grad is not None
    assert not bool(model.layers_dir[3].weight.grad.any())
    tx = optax.adamw(5e-4, b1=0.9, b2=0.999, eps=1e-8, weight_decay=1e-4)
    w = jnp.asarray(before.numpy())
    update, _ = tx.update(jnp.zeros_like(w), tx.init(w), w)
    np.testing.assert_allclose(model.layers_dir[3].weight.detach().numpy(),
                               np.asarray(optax.apply_updates(w, update)), rtol=1e-6, atol=1e-9)
    assert not torch.equal(model.layers_dir[3].weight.detach(), before)


TINY_PAPER_PY = """
_model = {{"type": "PaperNeRFModel", "num_encoding_fn_xyz": 10, "num_encoding_fn_dir": 4}}
cfg = {{
    "experiment": {{"id": "tiny_paper", "logdir": {logdir!r}, "randomseed": 3,
                    "train_iters": 4, "print_every": 2, "validate_every": 4,
                    "save_every": 4}},
    "dataset": {{"type": "synthetic", "num_views": 2, "image_size": 6}},
    "models": {{"coarse": dict(_model), "fine": dict(_model)}},
    "optimizer": {{"type": "Adam", "lr": 5.0e-4}},
    "nerf": {{
        "train": {{"num_random_rays": 16, "num_coarse": 8, "num_fine": 8,
                   "white_background": True, "use_pallas_train": True,
                   "compute_dtype": "bfloat16"}},
        "validation": {{"num_coarse": 8, "num_fine": 8, "chunksize": 64,
                        "white_background": True}},
    }},
}}
"""


def test_train_nerf_writes_a_paper_checkpoint_that_eval_reads(tmp_path):
    cfg_path = tmp_path / "tiny_paper.py"
    cfg_path.write_text(TINY_PAPER_PY.format(logdir=str(tmp_path / "logs")))
    before = (fused_paper_mlp_train.fwd_launches, fused_paper_mlp_train.bwd_launches,
              fused_paper_mlp_train.wgmma_bwd_launches)
    calls = []
    real = tpt.paper_train_plain_fwd
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tpt, "paper_train_plain_fwd", lambda *a, **k: calls.append(1) or real(*a, **k))
        run = train_nerf.main(["--config", str(cfg_path), "--device", "cpu"])
    assert len(calls) == 2 * 4 and len(run.losses) == 4 and np.all(np.isfinite(run.losses))
    assert (fused_paper_mlp_train.fwd_launches, fused_paper_mlp_train.bwd_launches,
            fused_paper_mlp_train.wgmma_bwd_launches) == before
    ckpt = torch.load(run.checkpoint, weights_only=True)
    assert "layers_dir.3.weight" in ckpt["model_fine_state_dict"]
    assert len(ckpt["optimizer_state_dict"]["state"]) == 2 * 30
    result = eval_nerf.main(["--config", str(cfg_path), "--checkpoint", run.checkpoint,
                             "--savedir", str(tmp_path / "rendered"), "--num-poses", "1",
                             "--renderer", "plain", "--device", "cpu"])
    assert all(result.finite) and result.first_maps["rgb_fine"].shape == (6, 6, 3)
    cfg = load_config(str(cfg_path))
    kernel = eval_nerf.render_trajectory(cfg, run.checkpoint, str(tmp_path / "kernel"),
                                         num_poses=1, device="cpu")
    torch.testing.assert_close(kernel.first_maps["rgb_fine"], result.first_maps["rgb_fine"],
                               rtol=1e-4, atol=1e-4)

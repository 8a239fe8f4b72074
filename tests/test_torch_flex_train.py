"""The training kernel pair of nerf_tpu_torch against the JAX one.

On the CPU ``fused_flex_mlp_train`` runs its plain pair
(``flex_train_plain_fwd`` / ``flex_train_plain_bwd``, the hand-derived
backward); here it is held against ``nerf_tpu.ops.pallas.flex_train
.fused_flex_mlp_train`` run in Pallas interpret mode, as
``tests/test_pallas_flex_train.py`` runs it, on the same weights
(``load_jax_params``) and numpy inputs:

- float32 forward to rtol/atol 2e-4, and every one of the 16 parameter
  gradients under a random cotangent to a scaled atol of 2e-4 (the JAX
  package's own tolerances): the JAX kernel makes its sinusoids by the
  double-angle recurrence (flex_train.py:141-148), the port calls sin/cos;
- no gradient reaches pts or viewdirs;
- the plain pair against torch autograd of ``mlp_t_plain`` to 1e-5.

The gradient inputs are numpy seed 0. At seed 2 the JAX interpret kernel
itself differs from JAX's XLA autodiff by 1.4% of the largest trunk gradient
(a ReLU pre-activation near zero changes sign under its recurrence
sinusoids) while the port agrees with XLA autodiff to 1e-6; that case is held
against XLA autodiff.

JAX's CPU backend has no bf16 x bf16 -> f32 dot, so the interpret-mode
kernel cannot run in bfloat16 here. The bfloat16 case is held against JAX's
other bf16 training path, XLA autodiff of ``model.apply`` on a bf16
encoding. That path rounds every layer's output, bias add, cotangent and
bias-gradient sum to bf16, where the kernels keep f32 sums, and bf16 inputs
move near-zero pre-activations across 0; measured at these sizes, its
gradients lie up to 14% (norm) from the f32 ones, about twice as far as the
port's, so no elementwise 2e-2 bound holds between the two. The test holds
the forward to 2e-2, and each gradient leaf of the port to lie from JAX's
f32 gradient no farther (norm) than 1.1 times JAX's own bf16 path does: in
the trunk both are dominated by the same bf16 forward's mask changes and
come out about equal (e.g. 0.0926 vs 0.0924), nearer the output the port is
up to 20x closer.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine.renderer import RenderSettings, encode_points
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.ops.pallas.flex_train import fused_flex_mlp_train as jax_flex_train
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, load_jax_params
from nerf_tpu_torch.kernels import flex_train as ft
from nerf_tpu_torch.kernels.flex_train import fused_flex_mlp_train
from nerf_tpu_torch.kernels.mlp import IMAGES, pack_params, unpack_params
from nerf_tpu_torch.kernels.mlp_t import mlp_t_plain
from nerf_tpu_torch.models import FlexibleNeRFModel

torch.set_num_threads(1)
LEAVES = [f"{layer}.{leaf}" for layer in ("layer1", "layers_xyz.0", "layers_xyz.1",
                                          "layers_xyz.2", "fc_feat", "fc_alpha",
                                          "layers_dir.0", "fc_rgb")
          for leaf in ("kernel", "bias")]


@pytest.fixture(scope="module")
def flagship():
    jmodel = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4),
                             params)
    return jmodel, params, tmodel


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
    """The port's gradients through fused_flex_mlp_train, in the JAX layout."""
    tmodel.zero_grad()
    out = fused_flex_mlp_train(tmodel, torch.from_numpy(pts), torch.from_numpy(vd), compute_dtype)
    (out * torch.from_numpy(cot)).sum().backward()
    return out.detach().numpy(), convert_torch_state_dict(
        {k: p.grad for k, p in tmodel.named_parameters()})


@pytest.mark.parametrize("n,s", [(33, 8), (128, 4), (140, 24)])
def test_forward_matches_the_jax_kernel(flagship, n, s):
    _, params, tmodel = flagship
    pts, vd, _ = _inputs(n, s, seed=n + s)
    want = np.asarray(jax_flex_train(params, jnp.asarray(pts), jnp.asarray(vd), interpret=True))
    before = (fused_flex_mlp_train.fwd_launches, fused_flex_mlp_train.bwd_launches)
    with torch.no_grad():
        got = fused_flex_mlp_train(tmodel, torch.from_numpy(pts), torch.from_numpy(vd))
    assert (fused_flex_mlp_train.fwd_launches, fused_flex_mlp_train.bwd_launches) == before
    assert got.shape == (n, s, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def grads_f32(flagship):
    """Both packages' parameter gradients at n=65 (not a multiple of the JAX
    kernel's 128-ray tile), s=8, under one random cotangent."""
    _, params, tmodel = flagship
    pts, vd, cot = _inputs(65, 8, seed=0)
    want = jax.grad(lambda p: jnp.sum(
        jax_flex_train(p, jnp.asarray(pts), jnp.asarray(vd), interpret=True) * cot))(params)
    _, got = _port_grads(tmodel, pts, vd, cot, "float32")
    return got, want


@pytest.mark.parametrize("leaf", LEAVES)
def test_param_grads_match_the_jax_kernel(grads_f32, leaf):
    got, want = (_leaf(tree, leaf) for tree in grads_f32)
    assert got.shape == want.shape
    scale = max(np.abs(want).max(), 1e-3)
    np.testing.assert_allclose(got / scale, want / scale, atol=2e-4, err_msg=leaf)


def test_no_gradient_reaches_pts_or_viewdirs(flagship):
    _, _, tmodel = flagship
    pts, vd, _ = _inputs(16, 4, seed=3)
    pts, vd = torch.from_numpy(pts).requires_grad_(True), torch.from_numpy(vd).requires_grad_(True)
    fused_flex_mlp_train(tmodel, pts, vd).sum().backward()
    assert pts.grad is None and vd.grad is None      # torch's zero gradient
    assert all(p.grad is not None for p in tmodel.parameters())
    tmodel.zero_grad()


@pytest.mark.parametrize("n,s", [(1, 1), (9, 7), (24, 16)])
def test_plain_pair_matches_torch_autograd(n, s):
    """The hand-derived backward against autograd of the plain forward, f32."""
    model = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                              generator=torch.Generator().manual_seed(n))
    pts, vd, cot = (torch.from_numpy(a) for a in _inputs(n, s, seed=n * s))
    out = fused_flex_mlp_train(model, pts, vd)
    (out * cot).sum().backward()
    got = {k: p.grad.clone() for k, p in model.named_parameters()}
    model.zero_grad()
    want = mlp_t_plain(model, pts, vd)
    (want * cot).sum().backward()
    torch.testing.assert_close(out.detach(), want.detach(), rtol=1e-5, atol=1e-5)
    for name, p in model.named_parameters():
        scale = max(float(p.grad.abs().max()), 1e-3)
        torch.testing.assert_close(got[name] / scale, p.grad / scale, rtol=0, atol=1e-5,
                                   msg=name)


def _jax_autodiff(jmodel, params, pts, vd, cot, dtype):
    settings = RenderSettings(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)

    def loss(p):
        enc = encode_points(jnp.asarray(pts), jnp.asarray(vd), settings).astype(dtype)
        out = jmodel.apply(p, enc).astype(jnp.float32)
        return jnp.sum(out * cot), out

    (_, out), grads = jax.value_and_grad(loss, has_aux=True)(params)
    return np.asarray(out), grads


def test_grads_match_xla_autodiff_where_the_jax_kernel_flips_a_mask(flagship):
    jmodel, params, tmodel = flagship
    pts, vd, cot = _inputs(65, 8, seed=2)
    _, want = _jax_autodiff(jmodel, params, pts, vd, cot, jnp.float32)
    _, got = _port_grads(tmodel, pts, vd, cot, "float32")
    for leaf in LEAVES:
        a, b = _leaf(got, leaf), _leaf(want, leaf)
        scale = max(np.abs(b).max(), 1e-3)
        np.testing.assert_allclose(a / scale, b / scale, atol=1e-5, err_msg=leaf)


@pytest.mark.parametrize("n,s,seed", [(40, 8, 4), (40, 8, 0), (128, 16, 1)])
def test_bf16_matches_jax_xla_autodiff(flagship, n, s, seed):
    jmodel, params, tmodel = flagship
    pts, vd, cot = _inputs(n, s, seed=seed)
    want_out, want16 = _jax_autodiff(jmodel, params, pts, vd, cot, jnp.bfloat16)
    _, want32 = _jax_autodiff(jmodel, params, pts, vd, cot, jnp.float32)
    got_out, got = _port_grads(tmodel, pts, vd, cot, "bfloat16")
    np.testing.assert_allclose(got_out, want_out, rtol=2e-2, atol=2e-2)
    for leaf in LEAVES:
        a, b16, b32 = _leaf(got, leaf), _leaf(want16, leaf), _leaf(want32, leaf)
        norm = np.linalg.norm(b32)
        port, jax_bf16 = np.linalg.norm(a - b32) / norm, np.linalg.norm(b16 - b32) / norm
        assert port <= 1.1 * jax_bf16, (leaf, port, jax_bf16)


def test_packed_layouts_round_trip():
    model = FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    params = pack_params(model).detach()
    layers = unpack_params(params)
    assert params.numel() == 82820
    torch.testing.assert_close(layers["layers_xyz.1"][0], model.layers_xyz[1].weight.t())
    torch.testing.assert_close(layers["fc_alpha"][1], model.fc_alpha.bias)
    torch.testing.assert_close(layers["layers_dir.0"][0], model.layers_dir[0].weight[:, :128].t())
    wt = IMAGES.f32_backward.pack(params)
    assert wt.numel() == 74048
    torch.testing.assert_close(wt[:192].view(3, 64), model.fc_rgb.weight)
    # [fc_feat; fc_alpha] are contiguous (129, 128) rows: the fused head.
    fa = wt[192 + 64 * 128:192 + 64 * 128 + 129 * 128].view(129, 128)
    torch.testing.assert_close(fa, torch.cat([model.fc_feat.weight, model.fc_alpha.weight]))


def test_wrapper_raises_instead_of_falling_back(flagship):
    _, _, tmodel = flagship
    pts, vd = torch.zeros(2, 8, 3), torch.ones(2, 3)
    narrow = FlexibleNeRFModel(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4,
                               num_encoding_fn_dir=2)
    with pytest.raises(ValueError, match="not the shape"):
        fused_flex_mlp_train(narrow, pts, vd)
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_flex_mlp_train(tmodel, pts, vd, "float16")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        ft.flex_train_fwd(pts.to("meta"), torch.zeros(2, 64, device="meta"),
                          torch.zeros(82820, device="meta"))


def _renderer_settings(**kw):
    return trend.RenderSettings(num_coarse=8, num_fine=8, perturb=False,
                                radiance_field_noise_std=0.0, white_background=True,
                                num_encoding_fn_xyz=10, num_encoding_fn_dir=4, **kw)


def test_renderer_dispatches_the_training_kernels(flagship, monkeypatch):
    """use_pallas_train routes the coarse and fine evaluations and their
    gradients through the pair; the loss and gradients equal the plain
    path's (f32); a shape the kernels do not take uses the plain path."""
    _, _, tmodel = flagship
    calls = []
    real = ft.flex_train_plain_fwd
    monkeypatch.setattr(ft, "flex_train_plain_fwd", lambda *a, **k: calls.append(1) or real(*a, **k))
    rng = np.random.default_rng(6)
    ro = torch.from_numpy(rng.uniform(-1, 1, (16, 3)).astype(np.float32))
    rd = ro - torch.tensor([0.0, 0.0, 2.0])
    results = {}
    for kernel in (True, False):
        tmodel.zero_grad()
        out = trend.render_rays(tmodel, tmodel, ro, rd, _renderer_settings(use_pallas_train=kernel))
        out.rgb.square().sum().backward()
        results[kernel] = (out.rgb.detach(), [p.grad.clone() for p in tmodel.parameters()])
    assert len(calls) == 2
    torch.testing.assert_close(results[True][0], results[False][0], rtol=1e-5, atol=1e-5)
    for a, b in zip(results[True][1], results[False][1]):
        scale = max(float(b.abs().max()), 1e-3)
        torch.testing.assert_close(a / scale, b / scale, rtol=0, atol=1e-5)

    narrow = FlexibleNeRFModel(num_encoding_fn_xyz=6, num_encoding_fn_dir=4)
    settings = dataclasses.replace(_renderer_settings(use_pallas_train=True), num_encoding_fn_xyz=6)
    trend.render_rays(narrow, None, ro, rd, settings)
    assert len(calls) == 2
    tmodel.zero_grad()


def test_remat_gives_the_plain_gradients(flagship):
    _, _, tmodel = flagship
    rng = np.random.default_rng(7)
    ro = torch.from_numpy(rng.uniform(-1, 1, (8, 3)).astype(np.float32))
    rd = ro - torch.tensor([0.0, 0.0, 2.0])
    grads = {}
    for remat in (True, False):
        tmodel.zero_grad()
        out = trend.render_rays(tmodel, None, ro, rd, _renderer_settings(remat=remat))
        out.rgb.sum().backward()
        grads[remat] = [p.grad.clone() for p in tmodel.parameters()]
    for a, b in zip(grads[True], grads[False]):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    tmodel.zero_grad()

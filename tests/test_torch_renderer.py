"""nerf_tpu_torch.engine.renderer against nerf_tpu.engine.renderer.

Both renderers get the same weights (JAX ``init`` carried by
``load_jax_params``) and the same rays, with ``perturb=False`` and no
sigma noise, so no random numbers enter. rgb/disp/acc agree to 1e-4: the
float32 radiance fields agree to ~1e-5 and compositing and resampling carry
that through.

With ``use_pallas=True`` the JAX side runs its kernel in interpret mode,
the way ``tests/test_pallas_mlp_t.py`` runs it (backend gate mocked); the
port's wrapper runs its plain version, since the tensors lie on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.data.poses import pose_spherical
from nerf_tpu.engine import renderer as jrend
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.ops import get_ray_bundle as jax_ray_bundle
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.kernels import mlp_t as tmlp_t
from nerf_tpu_torch.models import FlexibleNeRFModel

torch.set_num_threads(1)
TOL = 1e-4
MAPS = ("rgb", "disp", "acc")

SHAPES = {
    "narrow": (dict(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2),
               dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2)),
    "flagship": (dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4),
                 dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)),
}


def _models(name):
    model_kw, enc_kw = SHAPES[name]
    jmodel = JaxFlexible(**model_kw)
    pc, pf = jmodel.init(jax.random.PRNGKey(0)), jmodel.init(jax.random.PRNGKey(1))
    tc = load_jax_params(FlexibleNeRFModel(**model_kw), pc)
    tf = load_jax_params(FlexibleNeRFModel(**model_kw), pf)
    return jmodel, pc, pf, tc, tf, enc_kw


def _rays(h=4, w=4, theta=30.0):
    pose = pose_spherical(theta, -30.0, 4.0)[:3, :4]
    focal = 0.5 * w / np.tan(0.5 * 0.6911112070083618)
    ro, rd = jax_ray_bundle(h, w, focal, jnp.asarray(pose))
    return np.asarray(ro), np.asarray(rd), pose, focal


def _close(got, want, tol=TOL):
    if isinstance(got, torch.Tensor):
        got = got.detach()
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=tol, atol=tol)


@pytest.fixture
def jax_kernel_on_cpu(monkeypatch):
    """Let the JAX renderer reach its fused kernel here, in interpret mode."""
    import nerf_tpu.ops.pallas.mlp_t as jmlp_t

    real = jmlp_t.fused_mlp_t
    calls = []

    def interpret(*args, **kwargs):
        calls.append(1)
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(jmlp_t, "fused_mlp_t", interpret)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return calls


def _settings(enc_kw, **kw):
    base = dict(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                white_background=True, near=2.0, far=6.0, chunksize=16, **enc_kw)
    base.update(kw)
    return jrend.RenderSettings(**base), trend.RenderSettings(**base)


def _render_both(name, **kw):
    jmodel, pc, pf, tc, tf, enc_kw = _models(name)
    ro, rd, _, _ = _rays()
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    js, ts = _settings(enc_kw, **kw)
    want = jrend.render_rays(jmodel, pc, jmodel, pf, jnp.asarray(ro), jnp.asarray(rd), js, None)
    with torch.inference_mode():
        got = trend.render_rays(tc, tf, torch.from_numpy(ro), torch.from_numpy(rd), ts)
    return got, want


@pytest.mark.parametrize("name", list(SHAPES))
def test_render_rays_plain_path(name):
    got, want = _render_both(name)
    for stage in ("coarse", "fine"):
        for m in MAPS:
            _close(getattr(getattr(got, stage), m), getattr(getattr(want, stage), m))
    _close(got.rgb, want.rgb)


@pytest.mark.parametrize("name", list(SHAPES))
def test_render_rays_kernel_path(name, jax_kernel_on_cpu, monkeypatch):
    port_calls = []
    real = tmlp_t.fused_mlp_t

    def spy(*args, **kwargs):
        port_calls.append(1)
        return real(*args, **kwargs)

    monkeypatch.setattr(trend, "fused_mlp_t", spy)
    got, want = _render_both(name, use_pallas=True)
    fused = name == "flagship"                      # the only shape either kernel takes
    assert len(jax_kernel_on_cpu) == len(port_calls) == (2 if fused else 0)
    for stage in ("coarse", "fine"):
        for m in MAPS:
            _close(getattr(getattr(got, stage), m), getattr(getattr(want, stage), m))


def test_render_rays_ndc_and_aabb():
    got, want = _render_both("narrow", use_ndc=True, height=4, width=4, focal_length=3.5,
                             white_background=False)
    for m in MAPS:
        _close(getattr(got.fine, m), getattr(want.fine, m))
    got, want = _render_both("narrow", aabb=(-0.9, -0.8, -0.7, 0.8, 0.9, 1.0))
    for m in MAPS:
        _close(getattr(got.fine, m), getattr(want.fine, m))


def test_render_rays_coarse_only_and_one_model():
    jmodel, pc, _, tc, _, enc_kw = _models("narrow")
    ro, rd, _, _ = _rays()
    ro, rd = ro.reshape(-1, 3), rd.reshape(-1, 3)
    js, ts = _settings(enc_kw, num_fine=0)
    want = jrend.render_rays(jmodel, pc, None, None, jnp.asarray(ro), jnp.asarray(rd), js, None)
    got = trend.render_rays(tc, None, torch.from_numpy(ro), torch.from_numpy(rd), ts)
    assert got.fine is None and want.fine is None
    _close(got.rgb, want.rgb)
    maps = trend.render_maps_dict(got)
    assert set(maps) == set(jrend.render_maps_dict(want))


def test_image_renderer_with_a_ragged_last_chunk():
    jmodel, pc, pf, tc, tf, enc_kw = _models("narrow")
    ro, rd, _, _ = _rays(h=5, w=7)                  # 35 rays, chunks of 16
    js, ts = _settings(enc_kw)
    want = jrend.make_image_render_fn(jmodel, jmodel, js, jit=False)(
        pc, pf, jnp.asarray(ro), jnp.asarray(rd))
    got = trend.make_image_render_fn(tc, tf, ts)(torch.from_numpy(ro), torch.from_numpy(rd))
    assert set(got) == set(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape
        _close(got[key], value)


def test_pose_renderer_outputs():
    jmodel, pc, pf, tc, tf, enc_kw = _models("narrow")
    _, _, pose, focal = _rays()
    js, ts = _settings(enc_kw)
    want = jrend.make_pose_render_fn(jmodel, jmodel, js, 6, 5, focal)(pc, pf, jnp.asarray(pose))
    render = trend.make_pose_render_fn(tc, tf, ts, 6, 5, focal)
    got = render(torch.from_numpy(pose))
    assert got["rgb_u8"].dtype == torch.uint8 and tuple(got["rgb_u8"].shape) == (6, 5, 3)
    assert np.abs(got["rgb_u8"].numpy().astype(int) - np.asarray(want["rgb_u8"]).astype(int)).max() <= 1
    _close(got["rgb_fine"], want["rgb_fine"])
    u8 = trend.make_pose_render_fn(tc, tf, ts, 6, 5, focal, output="u8")(torch.from_numpy(pose))
    assert torch.equal(u8, got["rgb_u8"])
    f32 = trend.make_pose_render_fn(tc, tf, ts, 6, 5, focal, output="f32")(torch.from_numpy(pose))
    _close(f32, np.clip(np.asarray(want["rgb_fine"]), 0.0, 1.0))
    with pytest.raises(ValueError, match="output mode"):
        trend.make_pose_render_fn(tc, tf, ts, 6, 5, focal, output="png")


def test_training_options_raise_naming_the_roadmap(tmp_path):
    """The training options render now (use_pallas_train through the
    training kernels' plain pair here, remat through activation
    checkpointing, both equal to the plain path); what the training path
    still lacks raises naming its ROADMAP.md item, and --tighten-aabb
    refuses a run with no checkpoint."""
    from nerf_tpu_torch.engine.train import make_optimizer
    from nerf_tpu_torch.train_nerf import train

    _, _, _, tc, tf, enc_kw = _models("flagship")
    ro, rd, _, _ = _rays()
    ro, rd = torch.from_numpy(ro.reshape(-1, 3)), torch.from_numpy(rd.reshape(-1, 3))
    base = _settings(enc_kw)[1]
    with torch.no_grad():
        want = trend.render_rays(tc, tf, ro, rd, base)
        for option in ("use_pallas_train", "remat"):
            got = trend.render_rays(tc, tf, ro, rd, dataclasses.replace(base, **{option: True}))
            _close(got.rgb, want.rgb.numpy(), tol=1e-5)
    # The seven other optimizer names are ported (tests/test_torch_optimizers.py).
    assert make_optimizer("RMSprop", 1e-3).name == "rmsprop"
    from nerf_tpu_torch.config import get_default_config

    # Data-parallel training is ported (tests/test_torch_parallel_cli.py);
    # NCCL for ranks on the CPU is refused before any rank starts.
    with pytest.raises(ValueError, match="NCCL backend needs a CUDA device"):
        train(get_default_config(), logdir=str(tmp_path), device="cpu", num_devices=2,
              dist_backend="nccl")
    # --tighten-aabb is ported (tests/test_torch_geometry.py); with nothing
    # to resume from it refuses, as the JAX CLI does.
    with pytest.raises(SystemExit, match="needs a trained field to bound"):
        train(get_default_config(), logdir=str(tmp_path), device="cpu", tighten_aabb=2.0)


def test_perturbed_render_draws_from_the_generator():
    _, _, _, tc, tf, enc_kw = _models("narrow")
    ro, rd, _, _ = _rays()
    ro, rd = torch.from_numpy(ro.reshape(-1, 3)), torch.from_numpy(rd.reshape(-1, 3))
    settings = dataclasses.replace(_settings(enc_kw)[1], perturb=True, radiance_field_noise_std=1.0)
    a = trend.render_rays(tc, tf, ro, rd, settings, torch.Generator().manual_seed(0))
    b = trend.render_rays(tc, tf, ro, rd, settings, torch.Generator().manual_seed(0))
    c = trend.render_rays(tc, tf, ro, rd, settings.eval_variant())
    assert torch.equal(a.rgb, b.rgb) and not torch.equal(a.rgb, c.rgb)

"""The PaperNeRF render path of nerf_tpu_torch against the JAX package.

Weights come from the JAX ``PaperNeRFModel.init`` and reach the port through
``load_jax_params``; points, viewdirs and encoded inputs are made with numpy
from a seed and handed to both packages.

- The module: the state dict is ``to_torch_state_dict``'s key for key
  (``layers_dir.3`` included) and ``forward`` matches ``apply`` to 1e-5
  (float32 matmuls summed in another order).
- Kernel #4, ``fused_paper_mlp_t``: on CPU tensors the wrapper runs its plain
  version. Against the JAX kernel in Pallas interpret mode, at 10 and 6
  frequencies, to 5e-4 (atol and rtol): the JAX kernel makes its sinusoids by
  the double-angle recurrence (paper_t.py:100-110), whose phase error doubles
  per octave, while the port calls sin/cos of the exact x * 2^f; eight
  256-wide layers carry that gap to a few 1e-5 of the output at 10
  frequencies. Against the XLA ``apply`` on the same encoding (sin/cos both)
  to 1e-4. In bfloat16 against JAX's bf16 XLA path to 2e-2: that path rounds
  every layer's output and bias add to bf16 where the kernel keeps f32 sums.
- The slice: ``render_rays`` with Paper models, plain path and kernel path
  (JAX's kernel in interpret mode, backend gate mocked, as
  ``tests/test_torch_renderer.py`` does), rgb/disp/acc to 1e-4; a reference
  ``.ckpt`` the JAX package wrote renders through ``eval_nerf``.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.data.poses import pose_spherical
from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine.checkpoint import export_reference_checkpoint, to_torch_state_dict
from nerf_tpu.models import PaperNeRFModel as JaxPaper
from nerf_tpu.ops import get_ray_bundle as jax_ray_bundle
from nerf_tpu.ops.pallas.paper_t import fused_paper_mlp_t as jax_paper_t
from nerf_tpu_torch import eval_nerf
from nerf_tpu_torch.config import get_default_config, load_config, model_from_config
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine.checkpoint import load_jax_params, load_models_and_params
from nerf_tpu_torch.kernels import paper_t as tpaper_t
from nerf_tpu_torch.kernels.paper_t import (
    fused_paper_mlp_t,
    layout,
    num_params,
    pack_params,
    supports_fused_paper,
    unpack_params,
)
from nerf_tpu_torch.models import FlexibleNeRFModel, PaperNeRFModel

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHAPES = {
    "lego_paper": dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4),
    "reference_default": dict(num_encoding_fn_xyz=6, num_encoding_fn_dir=4),
    "no_viewdirs": dict(num_encoding_fn_xyz=4, num_encoding_fn_dir=2, use_viewdirs=False),
}


def _pair(name, seed=0):
    jmodel = JaxPaper(**SHAPES[name])
    params = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, params, load_jax_params(PaperNeRFModel(**SHAPES[name]), params)


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True)


@pytest.mark.parametrize("name", list(SHAPES))
def test_state_dict_keys_match_to_torch_state_dict(name):
    _, params, tmodel = _pair(name)
    want = to_torch_state_dict(params)
    got = tmodel.state_dict()
    assert list(got) == list(want)
    assert "layers_dir.3.weight" in got
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value)


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_matches_jax(name):
    jmodel, params, tmodel = _pair(name)
    x = np.random.default_rng(1).uniform(-1, 1, (5, 7, jmodel.input_dim)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 7, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_quirks_are_kept():
    model = PaperNeRFModel(num_layers=3, hidden_size=16, num_encoding_fn_xyz=10)
    assert len(model.layers_xyz) == 8 and model.layers_xyz[1].in_features == 256
    assert model.layers_xyz[4].in_features == 63 + 256 and len(model.layers_dir) == 4
    x = torch.randn(6, model.input_dim)
    with torch.no_grad():
        before = model(x)
        model.layers_dir[3].weight.add_(1.0)       # dead in the forward
        assert torch.equal(model(x), before)
        model.fc_alpha.bias.add_(1.0)              # alpha is the last channel
        torch.testing.assert_close(model(x)[:, 3], before[:, 3] + 1.0)


@pytest.mark.parametrize("compat", [False, True], ids=["sizes", "reference_compat_shapes"])
def test_model_from_config_builds_lego_paper(compat):
    cfg = load_config(os.path.join(REPO, "configs", "lego_paper.yml"))
    for which in ("coarse", "fine"):
        model = model_from_config(cfg.models[which], reference_compat_shapes=compat)
        assert isinstance(model, PaperNeRFModel) and supports_fused_paper(model)
        assert model.num_encoding_fn_xyz == 10 and model.dim_xyz == 63
        assert model.layers_dir[0].in_features == 256 + 27


@pytest.mark.parametrize("f,n,s", [(10, 33, 8), (10, 140, 12), (6, 33, 8), (6, 128, 4)])
def test_kernel_matches_the_jax_kernel(f, n, s):
    _, params, tmodel = _pair("lego_paper" if f == 10 else "reference_default")
    pts, vd = _inputs(n, s, seed=n + s + f)
    want = np.asarray(jax_paper_t(params, jnp.asarray(pts), jnp.asarray(vd), num_freq_xyz=f,
                                  interpret=True))
    before = fused_paper_mlp_t.launches
    with torch.no_grad():
        got = fused_paper_mlp_t(tmodel, torch.from_numpy(pts), torch.from_numpy(vd))
    assert fused_paper_mlp_t.launches == before          # the CPU runs the plain version
    assert got.shape == (n, s, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def _xla(jmodel, params, pts, vd, dtype):
    settings = jrend.RenderSettings(num_encoding_fn_xyz=jmodel.num_encoding_fn_xyz,
                                    num_encoding_fn_dir=jmodel.num_encoding_fn_dir)
    enc = jrend.encode_points(jnp.asarray(pts), jnp.asarray(vd), settings).astype(dtype)
    return np.asarray(jmodel.apply(params, enc).astype(jnp.float32))


@pytest.mark.parametrize("name", ["lego_paper", "reference_default"])
def test_kernel_matches_xla_apply(name):
    jmodel, params, tmodel = _pair(name)
    pts, vd = _inputs(24, 16, seed=4)
    with torch.no_grad():
        got = fused_paper_mlp_t(tmodel, torch.from_numpy(pts), torch.from_numpy(vd))
    np.testing.assert_allclose(got.numpy(), _xla(jmodel, params, pts, vd, jnp.float32),
                               rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("name", ["lego_paper", "reference_default"])
def test_bf16_matches_jax_bf16(name):
    jmodel, params, tmodel = _pair(name)
    pts, vd = _inputs(24, 16, seed=5)
    with torch.no_grad():
        got = fused_paper_mlp_t(tmodel, torch.from_numpy(pts), torch.from_numpy(vd), "bfloat16")
    np.testing.assert_allclose(got.numpy(), _xla(jmodel, params, pts, vd, jnp.bfloat16),
                               rtol=2e-2, atol=2e-2)


def test_gate_is_the_jax_gate():
    assert supports_fused_paper(PaperNeRFModel(num_encoding_fn_xyz=10))
    assert supports_fused_paper(PaperNeRFModel(num_encoding_fn_xyz=3))   # depth is free
    assert not supports_fused_paper(PaperNeRFModel(use_viewdirs=False))
    assert not supports_fused_paper(PaperNeRFModel(include_input_xyz=False))
    assert not supports_fused_paper(PaperNeRFModel(include_input_dir=False))
    assert not supports_fused_paper(FlexibleNeRFModel(num_encoding_fn_xyz=10))


def test_packed_layout_round_trips():
    model = PaperNeRFModel(num_encoding_fn_xyz=10)
    params = pack_params(model).detach()
    assert params.numel() == num_params(10) == 625416
    layers = unpack_params(params, 10)
    torch.testing.assert_close(layers["layers_xyz.4"][0], model.layers_xyz[4].weight.t())
    torch.testing.assert_close(layers["fc_alpha"][1], model.fc_alpha.bias)
    torch.testing.assert_close(layers["layers_dir.0"][0], model.layers_dir[0].weight[:, :256].t())
    torch.testing.assert_close(layers["fc_rgb"][1], model.fc_rgb.bias)
    off = 0
    for name, i, o in layout(10):              # short biases are zero-padded to 4 floats
        off += i * o
        assert torch.equal(params[off + o:off + -(-o // 4) * 4], torch.zeros(-o % 4)), name
        off += -(-o // 4) * 4
    assert off == params.numel()


def test_wrapper_raises_instead_of_falling_back():
    model = PaperNeRFModel(num_encoding_fn_xyz=10)
    pts, vd = torch.zeros(2, 8, 3), torch.ones(2, 3)
    with pytest.raises(ValueError, match="not a PaperNeRF shape"):
        fused_paper_mlp_t(PaperNeRFModel(use_viewdirs=False), pts, vd)
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_paper_mlp_t(model, pts, vd, "float16")
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_paper_mlp_t(model.to("meta"), pts.to("meta"), vd.to("meta"))


# --- the slice: renderer and eval entry point ------------------------------


@pytest.fixture
def jax_paper_kernel_on_cpu(monkeypatch):
    """Let the JAX renderer reach its Paper kernel here, in interpret mode."""
    import nerf_tpu.ops.pallas.paper_t as jpaper_t

    real = jpaper_t.fused_paper_mlp_t
    calls = []

    def interpret(*args, **kwargs):
        calls.append(1)
        return real(*args, **{**kwargs, "interpret": True})

    monkeypatch.setattr(jpaper_t, "fused_paper_mlp_t", interpret)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return calls


def _render_both(**kw):
    jmodel = JaxPaper(**SHAPES["reference_default"])
    pc, pf = jmodel.init(jax.random.PRNGKey(0)), jmodel.init(jax.random.PRNGKey(1))
    tc = load_jax_params(PaperNeRFModel(**SHAPES["reference_default"]), pc)
    tf = load_jax_params(PaperNeRFModel(**SHAPES["reference_default"]), pf)
    pose = pose_spherical(30.0, -30.0, 4.0)[:3, :4]
    focal = 0.5 * 4 / np.tan(0.5 * 0.6911112070083618)
    ro, rd = (np.asarray(a).reshape(-1, 3) for a in jax_ray_bundle(4, 4, focal, jnp.asarray(pose)))
    base = dict(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                white_background=True, near=2.0, far=6.0, chunksize=16,
                num_encoding_fn_xyz=6, num_encoding_fn_dir=4, **kw)
    want = jrend.render_rays(jmodel, pc, jmodel, pf, jnp.asarray(ro), jnp.asarray(rd),
                             jrend.RenderSettings(**base), None)
    with torch.inference_mode():
        got = trend.render_rays(tc, tf, torch.from_numpy(ro), torch.from_numpy(rd),
                                trend.RenderSettings(**base))
    return got, want


def _close_maps(got, want):
    for stage in ("coarse", "fine"):
        for m in ("rgb", "disp", "acc"):
            np.testing.assert_allclose(getattr(getattr(got, stage), m).numpy(),
                                       np.asarray(getattr(getattr(want, stage), m)),
                                       rtol=1e-4, atol=1e-4, err_msg=f"{stage}.{m}")


def test_render_rays_plain_path():
    _close_maps(*_render_both())


def test_render_rays_kernel_path(jax_paper_kernel_on_cpu, monkeypatch):
    port_calls = []
    real = tpaper_t.paper_t_plain
    monkeypatch.setattr(tpaper_t, "paper_t_plain",
                        lambda *a, **k: port_calls.append(1) or real(*a, **k))
    got, want = _render_both(use_pallas=True)
    assert len(jax_paper_kernel_on_cpu) == len(port_calls) == 2     # coarse + fine
    _close_maps(got, want)


def test_a_jax_paper_checkpoint_renders_through_eval(tmp_path):
    """A reference .ckpt of Paper params (layers_dir.3 included) that the JAX
    package wrote loads strictly into the port and renders the same frame
    through the kernel path (plain version here) and the plain path."""
    jmodel = JaxPaper(**SHAPES["lego_paper"])
    pc, pf = jmodel.init(jax.random.PRNGKey(2)), jmodel.init(jax.random.PRNGKey(3))
    path = str(tmp_path / "paper.ckpt")
    export_reference_checkpoint(path, 7, pc, pf, loss=0.1, psnr=10.0, hwf=(6, 6, 7.0))
    cfg = get_default_config()
    cfg.set_new_allowed(True)
    pairs = []
    for which in ("coarse", "fine"):
        pairs += [f"models.{which}.type", "PaperNeRFModel",
                  f"models.{which}.num_encoding_fn_xyz", 10]
    cfg.merge_from_list(pairs + ["nerf.validation.num_coarse", 8,
                                 "nerf.validation.num_fine", 8,
                                 "dataset.type", "synthetic"])
    mc, mf, _ = load_models_and_params(path, cfg)
    assert isinstance(mc, PaperNeRFModel) and isinstance(mf, PaperNeRFModel)
    x = np.random.default_rng(8).uniform(-1, 1, (9, jmodel.input_dim)).astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(mf(torch.from_numpy(x)).numpy(),
                                   np.asarray(jmodel.apply(pf, jnp.asarray(x))),
                                   rtol=1e-5, atol=1e-5)
    runs = {}
    for renderer in ("kernel", "plain"):
        before = fused_paper_mlp_t.launches
        runs[renderer] = eval_nerf.render_trajectory(cfg, path, str(tmp_path / renderer),
                                                     num_poses=1, renderer=renderer,
                                                     device="cpu")
        assert fused_paper_mlp_t.launches == before
    assert runs["kernel"].first_maps["rgb_fine"].shape == (6, 6, 3)
    torch.testing.assert_close(runs["kernel"].first_maps["rgb_fine"],
                               runs["plain"].first_maps["rgb_fine"], rtol=1e-4, atol=1e-4)
    assert all(runs["plain"].finite)

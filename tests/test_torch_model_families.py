"""The VeryTiny, MultiHead and Replicate families of nerf_tpu_torch.models
against nerf_tpu.models on the same weights.

- Each family's forward at a small width, with and without view directions
  where the family has the switch, against the JAX ``apply`` on the JAX
  ``init``'s weights (through ``load_jax_params``): 1e-6, float32 matmuls
  summed in another order.
- A reference-named state dict (``to_torch_state_dict`` of the JAX params)
  loads strictly, and the port's state dict converts back to the JAX params.
- ``model_from_config`` passes each family the JAX package's kwargs, in both
  modes, and the renderer never sends these families to a kernel: with
  ``use_pallas`` and ``use_pallas_train`` on it renders what the JAX
  renderer renders, to 1e-5.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.config import get_default_config as jax_default_config
from nerf_tpu.config import model_from_config as jax_model_from_config
from nerf_tpu.engine import renderer as jrend
from nerf_tpu.engine.checkpoint import to_torch_state_dict
from nerf_tpu.models import MultiHeadNeRFModel as JaxMultiHead
from nerf_tpu.models import ReplicateNeRFModel as JaxReplicate
from nerf_tpu.models import VeryTinyNeRFModel as JaxVeryTiny
from nerf_tpu_torch.config import get_default_config, model_from_config
from nerf_tpu_torch.engine import renderer as trend
from nerf_tpu_torch.engine.checkpoint import convert_torch_state_dict, load_jax_params
from nerf_tpu_torch.kernels.mlp import supports_fused
from nerf_tpu_torch.kernels.paper_t import supports_fused_paper
from nerf_tpu_torch.models import (
    MultiHeadNeRFModel,
    ReplicateNeRFModel,
    VeryTinyNeRFModel,
    get_model,
)

torch.set_num_threads(1)
TOL = 1e-6

FAMILIES = {
    "verytiny": (JaxVeryTiny, VeryTinyNeRFModel, dict(filter_size=16, num_encoding_functions=3)),
    "verytiny_noview": (JaxVeryTiny, VeryTinyNeRFModel,
                        dict(filter_size=16, num_encoding_functions=3, use_viewdirs=False)),
    "multihead": (JaxMultiHead, MultiHeadNeRFModel, dict(hidden_size=16, num_encoding_functions=3)),
    "multihead_noview": (JaxMultiHead, MultiHeadNeRFModel,
                         dict(hidden_size=16, num_encoding_functions=2, use_viewdirs=False)),
    "replicate": (JaxReplicate, ReplicateNeRFModel,
                  dict(hidden_size=16, num_encoding_fn_xyz=3, num_encoding_fn_dir=2)),
    "replicate_noinput": (JaxReplicate, ReplicateNeRFModel,
                          dict(hidden_size=16, num_layers=7, num_encoding_fn_xyz=2,
                               num_encoding_fn_dir=1, include_input_xyz=False,
                               include_input_dir=False)),
}


def _pair(name, seed=0):
    jcls, tcls, kw = FAMILIES[name]
    jmodel = jcls(**kw)
    params = jmodel.init(jax.random.PRNGKey(seed))
    return jmodel, params, load_jax_params(tcls(**kw), params)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_forward_matches_jax(name):
    jmodel, params, tmodel = _pair(name)
    assert tmodel.input_dim == jmodel.input_dim
    x = np.random.default_rng(1).uniform(-1, 1, (5, 7, jmodel.input_dim)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 7, 4)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", list(FAMILIES))
def test_reference_state_dict_loads(name):
    _, params, tmodel = _pair(name, seed=3)
    ref = {k: torch.from_numpy(np.asarray(v)) for k, v in to_torch_state_dict(params).items()}
    fresh = FAMILIES[name][1](**FAMILIES[name][2])
    fresh.load_state_dict(ref, strict=True)
    assert list(fresh.state_dict()) == list(tmodel.state_dict())
    back = convert_torch_state_dict(fresh.state_dict())
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_reference_attribute_names():
    assert [k for k, _ in VeryTinyNeRFModel().named_parameters()] == [
        "layer1.weight", "layer1.bias", "layer2.weight", "layer2.bias", "layer3.weight",
        "layer3.bias"]
    assert [k.split(".")[0] for k, _ in MultiHeadNeRFModel().named_parameters()][::2] == [
        "layer1", "layer2", "layer3_1", "layer3_2", "layer4", "layer5", "layer6"]
    assert [k.split(".")[0] for k, _ in ReplicateNeRFModel().named_parameters()][::2] == [
        "layer1", "layer2", "layer3", "fc_alpha", "layer4", "layer5", "fc_rgb"]
    # The quirks: dim_dir == dim_xyz; Replicate ignores num_layers.
    assert VeryTinyNeRFModel(num_encoding_functions=5).layer1.in_features == 2 * 33
    assert MultiHeadNeRFModel(num_encoding_functions=5).layer4.in_features == 33 + 128
    a, b = ReplicateNeRFModel(num_layers=2), ReplicateNeRFModel(num_layers=9)
    assert [p.shape for p in a.parameters()] == [p.shape for p in b.parameters()]


@pytest.mark.parametrize("compat", [False, True], ids=["sizes", "reference_compat"])
@pytest.mark.parametrize("family", ["VeryTinyNeRFModel", "MultiHeadNeRFModel",
                                    "ReplicateNeRFModel"])
def test_model_from_config_matches_jax(family, compat):
    overrides = ["models.coarse.type", family, "models.coarse.hidden_size", 24,
                 "models.coarse.num_layers", 3, "models.coarse.num_encoding_fn_xyz", 5,
                 "models.coarse.num_encoding_fn_dir", 3, "models.coarse.use_viewdirs", False,
                 "models.coarse.include_input_dir", False]
    jcfg, tcfg = jax_default_config(), get_default_config()
    jcfg.merge_from_list(overrides)
    tcfg.merge_from_list(overrides)
    jmodel = jax_model_from_config(jcfg.models.coarse, reference_compat_shapes=compat)
    tmodel = model_from_config(tcfg.models.coarse, reference_compat_shapes=compat)
    want = {f.name: getattr(jmodel, f.name) for f in dataclasses.fields(jmodel)}
    assert {k: getattr(tmodel, k) for k in want} == want
    params = jmodel.init(jax.random.PRNGKey(0))
    got = {k: tuple(v.shape) for k, v in tmodel.state_dict().items()}
    assert got == {k: tuple(np.shape(v)) for k, v in to_torch_state_dict(params).items()}


def test_get_model_builds_every_family():
    for name in ("VeryTinyNeRFModel", "MultiHeadNeRFModel", "ReplicateNeRFModel"):
        model = get_model(name)
        assert not supports_fused(model) and not supports_fused_paper(model)
    with pytest.raises(ValueError, match="Unknown model type"):
        get_model("NoSuchModel")


@pytest.mark.parametrize("name", ["verytiny", "multihead", "replicate"])
def test_renders_on_the_plain_path_with_kernels_on(name):
    jmodel, params, tmodel = _pair(name, seed=5)
    n_dir = getattr(jmodel, "num_encoding_functions", None)
    enc = (dict(num_encoding_fn_xyz=n_dir, num_encoding_fn_dir=n_dir) if n_dir is not None
           else dict(num_encoding_fn_xyz=3, num_encoding_fn_dir=2))
    base = dict(num_coarse=8, num_fine=8, perturb=False, radiance_field_noise_std=0.0,
                white_background=True, near=2.0, far=6.0, **enc)
    rng = np.random.default_rng(2)
    ro = (rng.uniform(-0.3, 0.3, (16, 3)) + [0.0, 0.0, 4.0]).astype(np.float32)
    rd = (rng.normal(size=(16, 3)) * 0.15 + [0.0, 0.0, -1.0]).astype(np.float32)
    want = jrend.render_rays(jmodel, params, jmodel, params, jnp.asarray(ro), jnp.asarray(rd),
                             jrend.RenderSettings(**base))
    settings = trend.RenderSettings(**base, use_pallas=True, use_pallas_train=True)
    with torch.no_grad():
        got = trend.render_rays(tmodel, tmodel, torch.from_numpy(ro), torch.from_numpy(rd),
                                settings)
    np.testing.assert_allclose(got.rgb.numpy(), np.asarray(want.rgb), rtol=1e-5, atol=1e-5)

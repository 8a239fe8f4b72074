"""nerf_tpu_torch.models against nerf_tpu.models on the same weights.

Weights come from the JAX ``model.init(PRNGKey)`` and reach the port through
``load_jax_params``; encoded inputs are made with numpy. Tolerance 1e-5:
float32 matmuls summed in another order.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine.checkpoint import export_reference_checkpoint, to_torch_state_dict
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch.config import get_default_config
from nerf_tpu_torch.engine.checkpoint import (
    convert_torch_state_dict,
    load_jax_params,
    load_models_and_params,
    load_reference_checkpoint,
)
from nerf_tpu_torch.models import FlexibleNeRFModel, PaperNeRFModel, get_model

torch.set_num_threads(1)

SHAPES = {
    "narrow": dict(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4, num_encoding_fn_dir=2),
    "skip": dict(num_layers=6, hidden_size=32, skip_connect_every=4, num_encoding_fn_xyz=4,
                 num_encoding_fn_dir=2),
    "flagship": dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4),
    "no_viewdirs": dict(num_layers=3, hidden_size=32, num_encoding_fn_xyz=4,
                        num_encoding_fn_dir=2, use_viewdirs=False),
}


def _pair(name, seed=0):
    jmodel = JaxFlexible(**SHAPES[name])
    params = jmodel.init(jax.random.PRNGKey(seed))
    tmodel = load_jax_params(FlexibleNeRFModel(**SHAPES[name]), params)
    return jmodel, params, tmodel


@pytest.mark.parametrize("name", list(SHAPES))
def test_forward_matches_jax(name):
    jmodel, params, tmodel = _pair(name)
    x = np.random.default_rng(1).uniform(-1, 1, (5, 7, jmodel.input_dim)).astype(np.float32)
    want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = tmodel(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, 7, 4)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_skip_shape_concatenates_the_encoding():
    jmodel, params, tmodel = _pair("skip")
    assert jmodel._has_skip(4) and tmodel._has_skip(4)
    assert tmodel.layers_xyz[4].in_features == tmodel.dim_xyz + 32
    assert tmodel.layers_xyz[3].in_features == 32


@pytest.mark.parametrize("name", list(SHAPES))
def test_state_dict_keys_match_to_torch_state_dict(name):
    _, params, tmodel = _pair(name)
    want = to_torch_state_dict(params)
    got = tmodel.state_dict()
    assert list(got) == list(want)
    for key, value in want.items():
        assert tuple(got[key].shape) == value.shape
        np.testing.assert_array_equal(got[key].numpy(), value)
    back = convert_torch_state_dict(got)
    np.testing.assert_array_equal(back["layer1"]["kernel"], np.asarray(params["layer1"]["kernel"]))


def test_init_is_linear_style_and_seeded():
    a = FlexibleNeRFModel(generator=torch.Generator().manual_seed(3))
    b = FlexibleNeRFModel(generator=torch.Generator().manual_seed(3))
    c = FlexibleNeRFModel(generator=torch.Generator().manual_seed(4))
    for (name, pa), pb, pc in zip(a.named_parameters(), b.parameters(), c.parameters()):
        layer = a.get_submodule(name.rsplit(".", 1)[0])
        bound = 1.0 / np.sqrt(layer.in_features)
        assert float(pa.abs().max()) <= bound
        assert torch.equal(pa, pb)
        assert not torch.equal(pa, pc)


def test_get_model_raises_for_replicate():
    assert isinstance(get_model("FlexibleNeRFModel", hidden_size=16), FlexibleNeRFModel)
    assert isinstance(get_model("PaperNeRFModel", num_encoding_fn_xyz=10), PaperNeRFModel)
    # Replicate is ported (tests/test_torch_model_families.py); only an
    # unknown name raises.
    from nerf_tpu_torch.models import ReplicateNeRFModel

    assert isinstance(get_model("ReplicateNeRFModel"), ReplicateNeRFModel)
    with pytest.raises(ValueError, match="Unknown model type"):
        get_model("NoSuchModel")


def test_reference_ckpt_from_jax_loads_in_the_port(tmp_path):
    jmodel = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    pc, pf = jmodel.init(jax.random.PRNGKey(5)), jmodel.init(jax.random.PRNGKey(6))
    path = str(tmp_path / "ref.ckpt")
    export_reference_checkpoint(path, 123, pc, pf, loss=0.5, psnr=20.0, hwf=(8, 6, 7.5))

    ckpt = load_reference_checkpoint(path)
    assert ckpt["step"] == 123 and ckpt["psnr"] == pytest.approx(20.0)
    assert (ckpt["height"], ckpt["width"]) == (8, 6)

    cfg = get_default_config()
    model_coarse, model_fine, _ = load_models_and_params(path, cfg)
    x = np.random.default_rng(7).uniform(-1, 1, (9, jmodel.input_dim)).astype(np.float32)
    for tmodel, params in ((model_coarse, pc), (model_fine, pf)):
        want = np.asarray(jmodel.apply(params, jnp.asarray(x)))
        with torch.no_grad():
            got = tmodel(torch.from_numpy(x)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_load_models_refuses_native_checkpoints(tmp_path):
    """A native .ntc loads into the models as configured (not the reference's
    default shapes), strictly: one of another shape is refused, and so is a
    file that is neither .ntc nor .ckpt."""
    from nerf_tpu.engine.checkpoint import save_checkpoint

    path = str(tmp_path / "model.ntc")
    params = JaxFlexible(**SHAPES["narrow"]).init(jax.random.PRNGKey(0))
    save_checkpoint(path, {"step": 3, "params_coarse": params, "params_fine": None})
    cfg = get_default_config()                      # 4x128 models, 6/4 encoding functions
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_models_and_params(path, cfg)
    for key, value in SHAPES["narrow"].items():
        cfg.merge_from_list([f"models.coarse.{key}", value, f"models.fine.{key}", value])
    model_coarse, model_fine, ckpt = load_models_and_params(path, cfg)
    assert model_fine is None and ckpt["step"] == 3
    assert model_coarse.layer1.weight.shape == (32, 27)
    with pytest.raises(ValueError, match=".ntc or a reference .ckpt"):
        load_models_and_params(str(tmp_path / "model.pt"), cfg)

"""nerf_tpu_torch.convert_checkpoint against the JAX CLI.

- ``.ckpt -> .ntc``: the port's file is the JAX CLI's byte for byte, for a
  reference checkpoint of each family.
- ``.ntc -> .ckpt``: the same ``torch.load`` contents as the JAX CLI's
  (iteration, loss, PSNR, intrinsics, both state dicts in the reference's
  parameter order, and the optimizer state dict with the ``.ntc``'s Adam
  moments in torch's layout), from a ``.ntc`` that holds the JAX trainer's
  ``optax.flatten`` Adam state and from one that holds none.
- ``.ckpt -> .ntc -> .ckpt`` gives back the model state dicts bitwise.
"""

import importlib
import sys
import os

import jax
import numpy as np
import optax
import pytest
import torch

from nerf_tpu.engine import train as jtrain
from nerf_tpu.engine.checkpoint import _tuples_to_lists
from nerf_tpu.engine.checkpoint import export_reference_checkpoint as jax_export
from nerf_tpu.engine.checkpoint import save_checkpoint as jax_save
from nerf_tpu.models import FlexibleNeRFModel, MultiHeadNeRFModel, ReplicateNeRFModel
from nerf_tpu_torch import convert_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FAMILIES = {
    "flexible": FlexibleNeRFModel(num_layers=2, hidden_size=16, num_encoding_fn_xyz=3,
                                  num_encoding_fn_dir=2),
    "multihead": MultiHeadNeRFModel(hidden_size=16, num_encoding_functions=2),
    "replicate": ReplicateNeRFModel(hidden_size=16, num_encoding_fn_xyz=2,
                                    num_encoding_fn_dir=1),
}


def _run_jax_cli(argv, monkeypatch):
    monkeypatch.syspath_prepend(REPO)
    module = importlib.import_module("convert_checkpoint")
    monkeypatch.setattr(sys, "argv", ["convert_checkpoint.py", *argv])
    module.main()


def _params(family):
    model = FAMILIES[family]
    return model.init(jax.random.PRNGKey(1)), model.init(jax.random.PRNGKey(2))


def _assert_same_ckpt(a, b):
    a, b = torch.load(a, weights_only=True), torch.load(b, weights_only=True)
    assert list(a) == list(b)
    for key in a:
        if key.endswith("state_dict") and key.startswith("model"):
            if a[key] is None:
                assert b[key] is None
                continue
            assert list(a[key]) == list(b[key])
            for name in a[key]:
                assert torch.equal(a[key][name], b[key][name]), name
        elif key == "optimizer_state_dict":
            assert a[key]["param_groups"] == b[key]["param_groups"]
            assert list(a[key]["state"]) == list(b[key]["state"])
            for i, entry in a[key]["state"].items():
                assert list(entry) == list(b[key]["state"][i])
                for name, v in entry.items():
                    assert torch.equal(v, b[key]["state"][i][name]), (i, name)
        else:
            assert a[key] == b[key], key


@pytest.mark.parametrize("family", list(FAMILIES))
def test_ckpt_to_ntc_bytes_match_jax(family, tmp_path, monkeypatch):
    pc, pf = _params(family)
    ckpt = str(tmp_path / "ref.ckpt")
    jax_export(ckpt, 12, pc, pf if family != "multihead" else None, loss=0.25, psnr=21.5,
               hwf=(8, 6, 7.5))
    _run_jax_cli(["--input", ckpt, "--output", str(tmp_path / "jax.ntc")], monkeypatch)
    convert_checkpoint.main(["--input", ckpt, "--output", str(tmp_path / "port.ntc")])
    assert (tmp_path / "port.ntc").read_bytes() == (tmp_path / "jax.ntc").read_bytes()
    # ... and back: the JAX CLI's file, and the state dicts bitwise the
    # original's (the .ntc sorts the layer names, as it does in JAX).
    convert_checkpoint.main(["--input", str(tmp_path / "port.ntc"),
                             "--output", str(tmp_path / "back.ckpt")])
    _run_jax_cli(["--input", str(tmp_path / "jax.ntc"), "--output", str(tmp_path / "jback.ckpt")],
                 monkeypatch)
    _assert_same_ckpt(str(tmp_path / "back.ckpt"), str(tmp_path / "jback.ckpt"))
    a = torch.load(ckpt, weights_only=True)
    b = torch.load(tmp_path / "back.ckpt", weights_only=True)
    for key in ("model_coarse_state_dict", "model_fine_state_dict"):
        if a[key] is None:
            assert b[key] is None
            continue
        assert sorted(a[key]) == sorted(b[key])
        assert all(torch.equal(a[key][k], b[key][k]) for k in a[key])
    assert (b["iter"], b["loss"], b["psnr"]) == (12, 0.25, 21.5)


@pytest.mark.parametrize("with_moments", [True, False], ids=["adam_state", "no_state"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_ntc_to_ckpt_matches_jax(family, with_moments, tmp_path, monkeypatch):
    pc, pf = _params(family)
    state = {"step": np.asarray(30), "params_coarse": jax.tree.map(np.asarray, pc),
             "params_fine": jax.tree.map(np.asarray, pf), "loss": np.asarray(0.5),
             "psnr": np.asarray(18.0)}
    if with_moments:
        opt = jtrain.make_optimizer("adam", 5e-3, 250, 0.1)
        trainable = {"coarse": pc, "fine": pf}
        opt_state = opt.init(trainable)
        rng = np.random.default_rng(4)
        for _ in range(2):
            g = jax.tree.map(lambda x: rng.normal(size=np.shape(x)).astype(np.float32), trainable)
            u, opt_state = opt.update(g, opt_state, trainable)
            trainable = optax.apply_updates(trainable, u)
        state["opt_state"] = _tuples_to_lists(jax.device_get(opt_state))
    ntc = str(tmp_path / "run.ntc")
    jax_save(ntc, state)
    flags = ["--input", ntc, "--hwf", "8", "6", "7.5", "--lr", "1e-3"]
    _run_jax_cli([*flags, "--output", str(tmp_path / "jax.ckpt")], monkeypatch)
    convert_checkpoint.main([*flags, "--output", str(tmp_path / "port.ckpt")])
    _assert_same_ckpt(str(tmp_path / "port.ckpt"), str(tmp_path / "jax.ckpt"))
    sd = torch.load(tmp_path / "port.ckpt", weights_only=True)["optimizer_state_dict"]
    assert len(sd["state"]) == (len(sd["param_groups"][0]["params"]) if with_moments else 0)


def test_unsupported_direction_refuses(tmp_path):
    with pytest.raises(SystemExit, match="Unsupported conversion"):
        convert_checkpoint.main(["--input", "a.ntc", "--output", "b.ntc"])

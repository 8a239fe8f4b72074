"""Native .ntc checkpoints: nerf_tpu_torch's stdlib msgpack codec against flax.

The JAX package writes ``.ntc`` files with ``flax.serialization``; the port
reads and writes the same bytes with ``nerf_tpu_torch/utils/msgpack.py``.
Both directions are held against flax here: the port reads what the JAX
``save_checkpoint`` wrote (optax state, chunked arrays included), flax reads
what the port wrote, and the port's bytes are flax's bytes.
"""

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import optax
import pytest
import torch
from flax import serialization

from nerf_tpu.engine import checkpoint as jax_ckpt
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu_torch import eval_nerf
from nerf_tpu_torch.config import get_default_config
from nerf_tpu_torch.engine import checkpoint as ckpt
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.utils import msgpack as codec

torch.set_num_threads(1)
NARROW = dict(num_layers=2, hidden_size=16, num_encoding_fn_xyz=2, num_encoding_fn_dir=1)


def _assert_same_tree(got, want):
    assert jax.tree_util.tree_structure(got) == jax.tree_util.tree_structure(want)
    for a, b in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)):
        assert type(a) is type(b), (a, b)
        if isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def _jax_train_state(seed=0):
    """What the JAX trainer saves (train_nerf.py:536-546): params, optax Adam
    state (tuples, turned to lists by save_checkpoint), step, loss, psnr."""
    model = JaxFlexible(**NARROW)
    pc = model.init(jax.random.PRNGKey(seed))
    pf = model.init(jax.random.PRNGKey(seed + 1))
    opt_state = optax.adam(5e-3).init({"coarse": pc, "fine": pf})
    return {"step": 7, "params_coarse": pc, "params_fine": pf, "opt_state": opt_state,
            "loss": 0.125, "psnr": 21.5}


def test_port_reads_what_jax_save_checkpoint_wrote(tmp_path):
    path = str(tmp_path / "checkpoint00007.ntc")
    jax_ckpt.save_checkpoint(path, _jax_train_state())
    got = ckpt.load_checkpoint(path)
    _assert_same_tree(got, jax_ckpt.load_checkpoint(path))
    assert got["step"] == 7 and got["loss"] == 0.125
    assert got["params_coarse"]["layer1"]["kernel"].dtype == np.float32


def test_jax_reads_what_the_port_wrote(tmp_path):
    model = FlexibleNeRFModel(**NARROW, generator=torch.Generator().manual_seed(3))
    state = {"step": 4, "params_coarse": ckpt.convert_torch_state_dict(model.state_dict()),
             "params_fine": None, "loss": 0.5, "psnr": np.float32(19.5),
             "rgb": torch.arange(6, dtype=torch.float32).reshape(2, 3)}
    path = str(tmp_path / "checkpoint00004.ntc")
    ckpt.save_checkpoint(path, state)
    got = jax_ckpt.load_checkpoint(path)
    numpy_state = dict(state, rgb=state["rgb"].numpy())
    _assert_same_tree(got, numpy_state)
    with open(path, "rb") as f:
        assert f.read() == serialization.msgpack_serialize(numpy_state)
    params = jax.tree.map(jnp.asarray, got["params_coarse"])
    x = np.random.default_rng(0).uniform(-1, 1, (5, model.dim_xyz + model.dim_dir))
    x = x.astype(np.float32)
    with torch.no_grad():
        np.testing.assert_allclose(np.asarray(JaxFlexible(**NARROW).apply(params, jnp.asarray(x))),
                                   model(torch.from_numpy(x)).numpy(), rtol=1e-5, atol=1e-5)


def test_chunked_arrays_both_ways(tmp_path, monkeypatch):
    """Arrays above MAX_CHUNK_SIZE bytes, in dicts (chunked) and in lists
    (never chunked, as flax walks dicts only)."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 40)
    monkeypatch.setattr(codec, "MAX_CHUNK_SIZE", 40)
    rng = np.random.default_rng(0)
    tree = {"big": rng.normal(size=(5, 7)).astype(np.float32),
            "nested": {"w": rng.normal(size=(3, 11)), "small": np.ones(3, np.float32)},
            "listed": [rng.normal(size=(4, 4)).astype(np.float32)]}
    path = str(tmp_path / "chunked.ntc")
    jax_ckpt.save_checkpoint(path, tree)
    with open(path, "rb") as f:
        data = f.read()
    assert b"__msgpack_chunked_array__" in data
    _assert_same_tree(ckpt.load_checkpoint(path), tree)
    assert codec.msgpack_serialize(tree) == data
    ckpt.save_checkpoint(str(tmp_path / "port.ntc"), tree)
    _assert_same_tree(jax_ckpt.load_checkpoint(str(tmp_path / "port.ntc")), tree)
    _assert_same_tree(codec.msgpack_restore(serialization.msgpack_serialize(tree["big"])),
                      tree["big"])


@pytest.mark.parametrize("value", [
    0, 127, 128, 255, 256, 65535, 65536, 2**32 - 1, 2**32, 2**64 - 1,
    -1, -32, -33, -128, -129, -32768, -32769, -2**31, -2**31 - 1, -2**63,
    0.0, -1.5, 1e300, float("inf"), True, False, None,
    "", "a" * 31, "a" * 32, "é" * 200, "b" * 256, "c" * 65536,
    b"", b"x" * 255, b"x" * 256, b"y" * 65536,
    list(range(15)), list(range(16)), list(range(65536)),
    {str(i): i for i in range(15)}, {str(i): i for i in range(16)},
    {"k": [1, {"v": None}]},
], ids=lambda v: f"{type(v).__name__}{len(v) if hasattr(v, '__len__') else v}")
def test_scalars_and_containers_take_msgpacks_encoding(value):
    want = msgpack.packb(value, use_bin_type=True)
    assert codec.packb(value) == want
    assert codec.unpackb(want) == msgpack.unpackb(want, raw=False)


@pytest.mark.parametrize("arr", [
    np.zeros((0, 3), np.float32), np.arange(5, dtype=np.int64), np.float64(2.5),
    np.int8(-3), np.bool_(True), np.arange(4, dtype=np.uint8).reshape(2, 2),
    np.linspace(0, 1, 300).reshape(3, 100),
], ids=["empty", "int64", "f64-scalar", "i8-scalar", "bool-scalar", "u8", "f64-300"])
def test_numpy_leaves_take_flaxs_ext_types(arr):
    want = serialization.msgpack_serialize({"a": arr})
    assert codec.msgpack_serialize({"a": arr}) == want
    _assert_same_tree(codec.msgpack_restore(want), serialization.msgpack_restore(want))


def test_bfloat16_arrays_are_read_as_float32():
    values = jnp.asarray([1.0, -2.5, 3.140625], jnp.bfloat16)
    got = codec.msgpack_restore(serialization.msgpack_serialize({"w": values}))["w"]
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(values.astype(jnp.float32)))


def test_bad_data_raises():
    with pytest.raises(ValueError, match="truncated"):
        codec.unpackb(msgpack.packb("abcdef")[:-2])
    with pytest.raises(ValueError, match="ext type"):
        codec.unpackb(msgpack.packb(msgpack.ExtType(9, b"x")))
    with pytest.raises(ValueError, match="map key"):
        codec.unpackb(msgpack.packb({1: 2}))
    with pytest.raises(TypeError, match="set"):
        codec.packb({1, 2})


def test_writes_are_atomic(tmp_path, monkeypatch):
    path = tmp_path / "checkpoint00001.ntc"
    ckpt.save_checkpoint(str(path), {"step": 1})

    def fail(_):
        raise OSError("disk full")

    monkeypatch.setattr(ckpt, "msgpack_serialize", fail)
    with pytest.raises(OSError):
        ckpt.save_checkpoint(str(path), {"step": 2})
    assert ckpt.load_checkpoint(str(path)) == {"step": 1}
    assert sorted(p.name for p in tmp_path.iterdir()) == ["checkpoint00001.ntc"]


def test_eval_renders_a_jax_ntc(tmp_path):
    """eval_nerf takes the .ntc the JAX trainer writes, into models built as
    configured (here 2x16, not the reference's 4x128)."""
    path = str(tmp_path / "checkpoint00007.ntc")
    jax_ckpt.save_checkpoint(path, _jax_train_state())
    cfg = get_default_config()
    cfg.set_new_allowed(True)
    pairs = ["dataset.type", "synthetic", "dataset.image_size", 12,
             "nerf.validation.num_coarse", 4, "nerf.validation.num_fine", 4]
    for key, value in NARROW.items():
        pairs += [f"models.coarse.{key}", value, f"models.fine.{key}", value]
    cfg.merge_from_list(pairs)
    result = eval_nerf.render_trajectory(cfg, path, str(tmp_path / "out"), num_poses=1,
                                         renderer="plain", device="cpu")
    assert all(result.finite) and (result.height, result.width) == (12, 12)

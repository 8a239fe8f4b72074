"""The point-major and ray-major 4x128 forwards of nerf_tpu_torch against the
JAX kernels.

On the CPU ``fused_flexible_mlp`` and ``fused_flexible_mlp_rays`` run their
plain PyTorch versions; here they are held against
``nerf_tpu.ops.pallas.mlp.fused_flexible_mlp`` and
``fused_flexible_mlp_rays`` run in Pallas interpret mode on the same weights
and numpy inputs, at float32 to 1e-4 (summation order, and sin/cos of
``x @ S`` against ``x * 2^f``), at point and ray counts that are no multiple
of the JAX tiles.

JAX's CPU backend has no bf16 x bf16 -> f32 dot, so the interpret-mode
kernels cannot run in bfloat16 here. The bfloat16 cases are held against the
JAX package's other bf16 evaluator, ``model.apply`` on a bf16 encoding, to
2e-2: that path also rounds every layer's output and bias add to bf16, where
the kernels keep f32 sums.

The kernels themselves run only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine.renderer import RenderSettings, encode_points
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.ops.pallas import mlp as jax_mlp
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.kernels import mlp, mlp_t
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.ops import positional_encoding

torch.set_num_threads(1)
ENC = dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)


@pytest.fixture(scope="module")
def flagship():
    params = JaxFlexible(**ENC).init(jax.random.PRNGKey(0))
    return params, load_jax_params(FlexibleNeRFModel(**ENC), params)


def _unit(rng, shape):
    v = rng.normal(size=shape).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def _jax_bf16(params, pts, vd):
    """The JAX package's bf16 evaluation of (..., S, 3) points seen along
    (..., 3) directions: model.apply on the bf16 encoding."""
    enc = encode_points(jnp.asarray(pts), jnp.asarray(vd), RenderSettings(**ENC))
    out = JaxFlexible(**ENC).apply(params, enc.astype(jnp.bfloat16))
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cpu_point_major_matches_the_jax_kernel(flagship, compute_dtype, tol):
    params, tmodel = flagship
    rng = np.random.default_rng(1)
    n = 300                                           # not a multiple of the JAX tile (256)
    pts = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    vd = _unit(rng, (n, 3))
    if compute_dtype == "float32":
        want = np.asarray(jax_mlp.fused_flexible_mlp(params, jnp.asarray(pts), jnp.asarray(vd),
                                                     tile=256, interpret=True))
    else:
        want = _jax_bf16(params, pts[:, None, :], vd)[:, 0]
    before = mlp.fused_flexible_mlp.launches
    with torch.no_grad():
        got = mlp.fused_flexible_mlp(tmodel, torch.from_numpy(pts), torch.from_numpy(vd),
                                     compute_dtype=compute_dtype)
    assert mlp.fused_flexible_mlp.launches == before      # the CPU never launches the kernel
    assert got.shape == (n, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
def test_cpu_ray_major_matches_the_jax_kernel(flagship, compute_dtype, tol):
    params, tmodel = flagship
    rng = np.random.default_rng(2)
    r, s = 20, 8                                      # 20 rays: not a multiple of 16 a tile
    pts = rng.uniform(-1.3, 1.3, (r, s, 3)).astype(np.float32)
    vd = _unit(rng, (r, 3))
    if compute_dtype == "float32":
        want = np.asarray(jax_mlp.fused_flexible_mlp_rays(
            params, jnp.asarray(pts), jnp.asarray(vd), rays_per_tile=16, interpret=True))
    else:
        want = _jax_bf16(params, pts, vd)
    before = mlp.fused_flexible_mlp_rays.launches
    with torch.no_grad():
        got = mlp.fused_flexible_mlp_rays(tmodel, torch.from_numpy(pts), torch.from_numpy(vd),
                                          compute_dtype=compute_dtype)
    assert mlp.fused_flexible_mlp_rays.launches == before
    assert got.shape == (r, s, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_the_two_layouts_are_one_function_in_float32(flagship):
    """Point-major on each sample with its ray's direction = ray-major = #1's
    plain version; in bfloat16 the point-major version also rounds the
    direction encoding, so there the two differ."""
    _, tmodel = flagship
    rng = np.random.default_rng(3)
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (7, 5, 3)).astype(np.float32))
    vd = torch.from_numpy(_unit(rng, (7, 3)))
    flat_vd = vd[:, None, :].expand(7, 5, 3).reshape(-1, 3)
    with torch.no_grad():
        rays = mlp.flexible_mlp_rays_plain(tmodel, pts, vd)
        points = mlp.flexible_mlp_plain(tmodel, pts.reshape(-1, 3), flat_vd).reshape(7, 5, 4)
        np.testing.assert_allclose(points.numpy(), rays.numpy(), rtol=1e-5, atol=1e-5)
        assert torch.equal(mlp_t.mlp_t_plain(tmodel, pts, vd), rays)
        bf16 = {k: f(tmodel, p, v, "bfloat16") for k, f, p, v in (
            ("rays", mlp.flexible_mlp_rays_plain, pts, vd),
            ("points", mlp.flexible_mlp_plain, pts.reshape(-1, 3), flat_vd))}
    assert not torch.equal(bf16["points"].reshape(7, 5, 4), bf16["rays"])
    np.testing.assert_allclose(bf16["points"].reshape(7, 5, 4).numpy(), bf16["rays"].numpy(),
                               rtol=2e-2, atol=2e-2)


def test_point_major_buffer_follows_the_kernel_layout(flagship):
    """The kernel's arithmetic, reading weights from the packed buffer at the
    offsets of csrc/flex_mlp.cuh (pack_params' 82820 floats, then the 27
    direction rows of layers_dir.0)."""
    _, tmodel = flagship
    buf = mlp.pack_params_points(tmodel)
    assert buf.numel() == 82820 + 27 * 64                 # kParamsDir
    offset = 0

    def take(*shape):
        nonlocal offset
        out = buf[offset:offset + int(np.prod(shape))].reshape(shape)
        offset += int(np.prod(shape))
        return out

    w1, b1 = take(63, 128), take(128)
    trunk = [(take(128, 128), take(128)) for _ in range(3)]
    wf, bf, wa, ba = take(128, 128), take(128), take(128, 1), take(1)
    wd, bd, wr, br, wdd = take(128, 64), take(64), take(64, 3), take(3), take(27, 64)
    rng = np.random.default_rng(4)
    pts = torch.from_numpy(rng.uniform(-1, 1, (9, 3)).astype(np.float32))
    vd = torch.from_numpy(_unit(rng, (9, 3)))
    with torch.no_grad():
        h = positional_encoding(pts, 10) @ w1 + b1
        for w, b in trunk:
            h = torch.relu(h @ w + b)
        hd = torch.relu(torch.relu(h @ wf + bf) @ wd + positional_encoding(vd, 4) @ wdd + bd)
        got = torch.cat([hd @ wr + br, h @ wa + ba], dim=-1)
        np.testing.assert_allclose(got.numpy(), mlp.flexible_mlp_plain(tmodel, pts, vd).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kwargs", [
    ENC,
    dict(num_encoding_fn_xyz=6, num_encoding_fn_dir=4),
    dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=2),
    dict(ENC, hidden_size=64),
    dict(ENC, num_layers=5),
    dict(ENC, use_viewdirs=False),
    dict(ENC, include_input_xyz=False),
    dict(ENC, include_input_dir=False),
], ids=["flagship", "xyz6", "dir2", "hidden64", "layers5", "no-viewdirs", "no-xyz-input",
        "no-dir-input"])
def test_gate_is_the_jax_gate(kwargs):
    jmodel = JaxFlexible(**kwargs)
    want = jax_mlp.supports_fused(jmodel, jmodel.init(jax.random.PRNGKey(0)))
    assert mlp.supports_fused(FlexibleNeRFModel(**kwargs)) == want
    assert mlp_t.supports_fused is mlp.supports_fused


def test_wrappers_raise_instead_of_falling_back(flagship):
    _, tmodel = flagship
    narrow = FlexibleNeRFModel(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4,
                               num_encoding_fn_dir=2)
    cases = ((mlp.fused_flexible_mlp, torch.zeros(8, 3), torch.ones(8, 3)),
             (mlp.fused_flexible_mlp_rays, torch.zeros(2, 4, 3), torch.ones(2, 3)))
    for fn, pts, vd in cases:
        with pytest.raises(ValueError, match="4x128"):
            fn(narrow, pts, vd)
        with pytest.raises(ValueError, match="no kernel for device meta"):
            fn(tmodel, pts.to("meta"), vd.to("meta"))
        with pytest.raises(ValueError, match="compute_dtype"):
            fn(tmodel, pts, vd, compute_dtype="float16")

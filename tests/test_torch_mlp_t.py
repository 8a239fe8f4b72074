"""The fused encode+MLP wrapper of nerf_tpu_torch against the JAX kernel.

On the CPU ``fused_mlp_t`` runs its plain PyTorch version; here it is held
against ``nerf_tpu.ops.pallas.mlp_t.fused_mlp_t`` run in Pallas interpret
mode on the same weights and numpy inputs, at float32 to 1e-4: the JAX
kernel makes its sinusoids by the double-angle recurrence (mlp_t.py:84-87)
where the port calls sin/cos directly.

JAX's CPU backend has no bf16 x bf16 -> f32 dot, so the interpret-mode
kernel cannot run in bfloat16 here. The bfloat16 case is held against the
JAX package's other bf16 evaluator, ``model.apply`` on a bf16 encoding (the
renderer's non-kernel path), to 2e-2: that path also rounds every layer's
output and bias add to bf16, where the kernel keeps f32 sums.

The kernel itself runs only on the card: tests/test_torch_cuda.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine.renderer import RenderSettings, encode_points
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.ops.pallas.mlp_t import fused_mlp_t as jax_fused_mlp_t
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.kernels import _build
from nerf_tpu_torch.kernels.mlp_t import (
    dir_contribution,
    fused_mlp_t,
    mlp_t_plain,
    pack_params,
    supports_fused,
)
from nerf_tpu_torch.models import FlexibleNeRFModel
from nerf_tpu_torch.ops import positional_encoding

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def flagship():
    jmodel = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4),
                             params)
    return params, tmodel


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True)


def _jax_reference(params, pts, vd, compute_dtype):
    pts, vd = jnp.asarray(pts), jnp.asarray(vd)
    if compute_dtype == "float32":
        return np.asarray(jax_fused_mlp_t(params, pts, vd, interpret=True))
    settings = RenderSettings(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    enc = encode_points(pts, vd, settings).astype(jnp.bfloat16)
    out = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).apply(params, enc)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n,s", [(33, 64), (5, 128)])
def test_cpu_path_matches_the_jax_kernel(flagship, n, s, compute_dtype, tol):
    params, tmodel = flagship
    pts, vd = _inputs(n, s, seed=n + s)
    want = _jax_reference(params, pts, vd, compute_dtype)
    before = fused_mlp_t.launches
    with torch.no_grad():
        got = fused_mlp_t(tmodel, torch.from_numpy(pts), torch.from_numpy(vd), compute_dtype)
    assert fused_mlp_t.launches == before           # the CPU never launches the kernel
    assert got.shape == (n, s, 4) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=tol, atol=tol)


def test_plain_matches_the_module_forward(flagship):
    """In float32 the plain version is the module's own forward, reordered."""
    _, tmodel = flagship
    pts, vd = _inputs(6, 16, seed=3)
    pts, vd = torch.from_numpy(pts), torch.from_numpy(vd)
    enc = torch.cat([positional_encoding(pts, 10),
                     positional_encoding(vd, 4)[:, None, :].expand(6, 16, 27)], dim=-1)
    with torch.no_grad():
        np.testing.assert_allclose(mlp_t_plain(tmodel, pts, vd).numpy(), tmodel(enc).numpy(),
                                   rtol=1e-5, atol=1e-5)


def _kernel_emulation(buf, pts, dc):
    """The kernel's arithmetic, reading weights from the packed buffer at the
    offsets of csrc/mlp_t.cu (layer1, layers_xyz.0-2, fc_feat, fc_alpha,
    layers_dir.0's feature rows, fc_rgb; each (in, out) then its bias)."""
    offset = 0

    def take(*shape):
        nonlocal offset
        size = int(np.prod(shape))
        out = buf[offset:offset + size].reshape(shape)
        offset += size
        return out

    w1, b1 = take(63, 128), take(128)
    trunk = [(take(128, 128), take(128)) for _ in range(3)]
    wf, bf, wa, ba = take(128, 128), take(128), take(128, 1), take(1)
    wd, bd, wr, br = take(128, 64), take(64), take(64, 3), take(3)
    assert offset == buf.numel() == 82820           # kParams in csrc/mlp_t.cu
    h = positional_encoding(pts, 10) @ w1 + b1
    for w, b in trunk:
        h = torch.relu(h @ w + b)
    hd = torch.relu(torch.relu(h @ wf + bf) @ wd + bd + dc[:, None, :])
    return torch.cat([hd @ wr + br, h @ wa + ba], dim=-1)


def test_packed_params_follow_the_kernel_layout(flagship):
    _, tmodel = flagship
    pts, vd = _inputs(4, 8, seed=4)
    pts, vd = torch.from_numpy(pts), torch.from_numpy(vd)
    with torch.no_grad():
        got = _kernel_emulation(pack_params(tmodel), pts, dir_contribution(tmodel, vd))
        np.testing.assert_allclose(got.numpy(), mlp_t_plain(tmodel, pts, vd).numpy(),
                                   rtol=1e-5, atol=1e-5)


def test_supports_fused_is_the_jax_gate():
    assert supports_fused(FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4))
    for kwargs in (dict(num_encoding_fn_xyz=6, num_encoding_fn_dir=4),
                   dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, hidden_size=64),
                   dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, num_layers=5),
                   dict(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, use_viewdirs=False)):
        assert not supports_fused(FlexibleNeRFModel(**kwargs))


def test_wrapper_raises_instead_of_falling_back(flagship):
    _, tmodel = flagship
    narrow = FlexibleNeRFModel(num_layers=2, hidden_size=32, num_encoding_fn_xyz=4,
                               num_encoding_fn_dir=2)
    pts, vd = torch.zeros(2, 8, 3), torch.ones(2, 3)
    with pytest.raises(ValueError, match="4x128"):
        fused_mlp_t(narrow, pts, vd)
    with pytest.raises(ValueError, match="no kernel for device meta"):
        fused_mlp_t(tmodel, pts.to("meta"), vd.to("meta"))
    with pytest.raises(ValueError, match="compute_dtype"):
        fused_mlp_t(tmodel, pts, vd, "float16")


def test_build_names_what_it_looked_for(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "NVCC_FALLBACK", str(tmp_path / "cuda" / "bin" / "nvcc"))
    with pytest.raises(RuntimeError, match="nvcc.*PATH.*cuda/bin/nvcc"):
        _build.find_nvcc()
    assert "--use_fast_math" not in _build.NVCC_FLAGS
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    assert _build.library_path().parent == _build.BUILD_DIR
    assert [p.name for p in _build._sources()] == ["composite.cu", "flex_train.cu",
                                                   "hashgrid.cu", "mlp.cu", "mlp_t.cu",
                                                   "paper_t.cu", "paper_train.cu",
                                                   "resample.cu", "stage.cu"]
    assert {"composite.cuh", "flex_mlp.cuh", "paper_mlp.cuh"} <= {
        p.name for p in _build.CSRC.glob("*.cuh")}

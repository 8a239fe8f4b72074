"""Tests of the hand-written kernels that need an NVIDIA GPU (sm_90a) and nvcc.

They skip without a card. On the card, where JAX is not installed, run them
without the suite's conftest (it imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports torch and the port only.
"""

import dataclasses

import pytest
import torch

from nerf_tpu_torch.engine import renderer
from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t, mlp_t_plain
from nerf_tpu_torch.models import FlexibleNeRFModel

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)


@pytest.fixture
def model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card (see module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator().manual_seed(0)
    return FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                             generator=gen).cuda().eval()


def _inputs(n, s, seed):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    pts = torch.rand(n, s, 3, generator=gen, device="cuda") * 6.0 - 3.0
    vd = torch.randn(n, 3, generator=gen, device="cuda")
    return pts, vd / torch.linalg.norm(vd, dim=-1, keepdim=True)


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n,s", [(1, 1), (33, 64), (1000, 128), (7, 61)])
def test_kernel_matches_plain(model, n, s, compute_dtype, tol):
    pts, vd = _inputs(n, s, seed=n * s)
    before = fused_mlp_t.launches
    with torch.inference_mode():
        got = fused_mlp_t(model, pts, vd, compute_dtype)
        torch.cuda.synchronize()
        want = mlp_t_plain(model, pts, vd, compute_dtype)
    assert fused_mlp_t.launches == before + 1
    assert got.shape == (n, s, 4) and got.dtype == torch.float32 and got.is_cuda
    assert float((got - want).abs().max()) <= tol


def test_kernel_takes_strided_points(model):
    pts, vd = _inputs(64, 32, seed=1)
    strided = pts.transpose(0, 1).contiguous().transpose(0, 1)
    assert not strided.is_contiguous()
    with torch.inference_mode():
        got = fused_mlp_t(model, strided, vd)
        torch.cuda.synchronize()
        assert torch.equal(got, fused_mlp_t(model, pts, vd))


def test_kernel_refuses_what_it_does_not_take(model):
    pts, vd = _inputs(4, 8, seed=2)
    with pytest.raises(ValueError, match="float32"):
        fused_mlp_t(model, pts.double(), vd.double())
    with pytest.raises(ValueError, match="want pts"):
        fused_mlp_t(model, pts, vd[:3])
    with pytest.raises(ValueError, match="share a device"):
        fused_mlp_t(FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4), pts, vd)


def test_renderer_goes_through_the_kernel(model):
    gen = torch.Generator(device="cuda").manual_seed(3)
    ro = torch.randn(500, 3, generator=gen, device="cuda") * 0.1 + torch.tensor(
        [0.0, 0.0, 4.0], device="cuda")
    rd = torch.randn(500, 3, generator=gen, device="cuda") * 0.2 - torch.tensor(
        [0.0, 0.0, 1.0], device="cuda")
    settings = renderer.RenderSettings(num_coarse=64, num_fine=0, perturb=False,
                                       white_background=True, num_encoding_fn_xyz=10,
                                       num_encoding_fn_dir=4, use_pallas=True)
    before = fused_mlp_t.launches
    with torch.inference_mode():
        fused = renderer.render_rays(model, None, ro, rd, settings)
        plain = renderer.render_rays(model, None, ro, rd,
                                     dataclasses.replace(settings, use_pallas=False))
    assert fused_mlp_t.launches == before + 1
    assert float((fused.rgb - plain.rgb).abs().max()) <= 1e-4

"""Tests of the hand-written kernels that need an NVIDIA GPU (sm_90a) and nvcc.

They skip without a card. On the card, where JAX is not installed, run them
without the suite's conftest (it imports JAX):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q

This file imports torch and the port only. The f32 instances of #1-#3, #7
and #8's forward and layer-gradient pass share flex_mlp.cuh's
register-blocked body, the f32 #4 and #9 paper_mlp.cuh's, and #8's and #9's
f32 weight-gradient passes fma_wgrad.cuh's: they are held to their plain
versions at point counts that end mid-tile and mid-slice (#8 and #9 also
mid-chunk, #9 at encoding depths 0, 6 and 16), and two launches bitwise
equal. The bf16 instances of #1-#4, #7
and the #8 and #9 pairs run on the tensor cores: their forwards are held
to TC_FWD_TOL (#3 bitwise to #1 too: the same sums, #1's on wgmma, one
wgmma launch a bf16 call, at a frame's four shapes), the bf16 backwards
(#9's weight gradients on wgmma, ``wgmma_bwd_launches`` one a bf16 call, at
depths 0-16, one and six scenes, counts that end mid-tile, mid-chunk and
mid-stage) against the plain backward on the forward
kernel's own residuals (a bf16 sum in another order flips roundings and ReLU
masks that an end-to-end comparison would follow), and #7's bf16 maps
bitwise against #5 on #1's bf16 field, the same arithmetic.
"""

import dataclasses

import pytest
import torch

from nerf_tpu_torch.engine import renderer
from nerf_tpu_torch.kernels.flex_train import (
    flex_train_bwd,
    flex_train_fwd,
    flex_train_plain_bwd,
    flex_train_plain_fwd,
    fused_flex_mlp_train,
    residuals_as_plain,
    unpack_params,
)
from nerf_tpu_torch.kernels import composite, mlp, paper_t, paper_train, resample, stage
from nerf_tpu_torch.kernels.mlp_t import dir_contribution, fused_mlp_t, mlp_t_plain, pack_params
from nerf_tpu_torch.models import FlexibleNeRFModel, PaperNeRFModel

pytestmark = pytest.mark.cuda
torch.set_num_threads(1)
# The tensor-core forwards against their bf16-emulating plain versions: a sum
# in another order flips a rounding and moves the output by ~5e-4.
TC_FWD_TOL = 2e-3


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


# A 400x400 frame's four calls of #1 (coarse and fine, a whole 131072-ray
# chunk and the rest of 160,000 rays), and ragged ones: samples that do not
# divide a 64-point tile.
FRAME_SHAPES = [(131072, 64), (131072, 128), (28928, 64), (28928, 128), (333, 48), (100, 100)]


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", TC_FWD_TOL)])
@pytest.mark.parametrize("n,s", [(1, 1), (33, 64), (1000, 128), (7, 61)] + FRAME_SHAPES)
def test_kernel_matches_plain(model, n, s, compute_dtype, tol):
    """#1 against its plain version; its bf16 instance is one launch of the
    wgmma body (csrc/flex_wg.cuh) a call."""
    pts, vd = _inputs(n, s, seed=n * s)
    before = (fused_mlp_t.launches, fused_mlp_t.wgmma_launches)
    with torch.inference_mode():
        got = fused_mlp_t(model, pts, vd, compute_dtype)
        torch.cuda.synchronize()
        want = mlp_t_plain(model, pts, vd, compute_dtype)
    bf16 = compute_dtype == "bfloat16"
    assert (fused_mlp_t.launches, fused_mlp_t.wgmma_launches) == (before[0] + 1, before[1] + bf16)
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


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n,s", [(1, 1), (1000, 128), (7, 61)])
def test_flexible_kernels_match_plain(model, n, s, compute_dtype, tol):
    """#3 (ray-major) and #2 (point-major, on the flattened points with each
    ray's direction) against their plain versions, their bf16 instances on
    the tensor cores to TC_FWD_TOL; #3 bitwise equal to #1 in both dtypes
    (in f32 #1's tile body on the same dc rows; in bf16 the mma.sync tile,
    whose sums #1's wgmma body takes in the same order)."""
    pts, vd = _inputs(n, s, seed=n + s)
    flat_pts, flat_vd = pts.reshape(-1, 3), vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
    before = (mlp.fused_flexible_mlp.launches, mlp.fused_flexible_mlp_rays.launches)
    with torch.inference_mode():
        rays = mlp.fused_flexible_mlp_rays(model, pts, vd, compute_dtype)
        points = mlp.fused_flexible_mlp(model, flat_pts, flat_vd, compute_dtype)
        one = fused_mlp_t(model, pts, vd, compute_dtype)
        torch.cuda.synchronize()
        want_rays = mlp.flexible_mlp_rays_plain(model, pts, vd, compute_dtype)
        want_points = mlp.flexible_mlp_plain(model, flat_pts, flat_vd, compute_dtype)
    assert (mlp.fused_flexible_mlp.launches, mlp.fused_flexible_mlp_rays.launches) == (
        before[0] + 1, before[1] + 1)
    assert rays.shape == (n, s, 4) and points.shape == (n * s, 4) and points.is_cuda
    assert float((rays - want_rays).abs().max()) <= min(tol, TC_FWD_TOL)
    assert float((points - want_points).abs().max()) <= min(tol, TC_FWD_TOL)
    assert torch.equal(rays, one)


def test_flexible_kernels_refuse_what_they_do_not_take(model):
    pts, vd = _inputs(4, 8, seed=2)
    with pytest.raises(ValueError, match="float32"):
        mlp.fused_flexible_mlp_rays(model, pts.double(), vd.double())
    with pytest.raises(ValueError, match="want pts"):
        mlp.fused_flexible_mlp_rays(model, pts, vd[:3])
    with pytest.raises(ValueError, match="want pts"):
        mlp.fused_flexible_mlp(model, pts, vd)
    with pytest.raises(ValueError, match="share a device"):
        mlp.fused_flexible_mlp(FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4),
                               pts.reshape(-1, 3), vd.repeat(8, 1))


def _train_case(model, n, s, compute_dtype, seed):
    pts, vd = _inputs(n, s, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    g = torch.randn(n, s, 4, generator=gen, device="cuda")
    params = pack_params(model).detach()
    dc = dir_contribution(model, vd).detach()
    return pts, dc, params, g


def _scaled_err(got, want):
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-3))


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n,s", [(1, 1), (33, 64), (1024, 128), (7, 61), (333, 61), (41, 50)])
def test_train_kernels_match_plain(model, n, s, compute_dtype, tol):
    """The forward and its residuals against the plain forward's (residuals
    scaled by the plain one's largest entry), every parameter gradient and
    ddc against the plain backward on the forward kernel's own residuals
    (scaled likewise). (333, 61) ends in a partial tile and a partial chunk
    (318 tiles), with rays that straddle tiles; (41, 50) is a 3-chunk run."""
    pts, dc, params, g = _train_case(model, n, s, compute_dtype, seed=n * s)
    fwd0, bwd0 = fused_flex_mlp_train.fwd_launches, fused_flex_mlp_train.bwd_launches
    out, res = flex_train_fwd(pts, dc, params, compute_dtype)
    grad, ddc = flex_train_bwd(g, res, params, n, s, compute_dtype)
    torch.cuda.synchronize()
    assert (fused_flex_mlp_train.fwd_launches, fused_flex_mlp_train.bwd_launches) == (
        fwd0 + 1, bwd0 + 1)
    want, want_res = flex_train_plain_fwd(pts, dc, params, compute_dtype)
    kernel_res = residuals_as_plain(res, n * s, compute_dtype)
    want_grad, want_ddc = flex_train_plain_bwd(g, kernel_res, params, n, s, compute_dtype)
    assert out.shape == (n, s, 4) and bool(torch.isfinite(out).all())
    assert float((out - want).abs().max()) <= min(tol, TC_FWD_TOL)
    for got_r, want_r in zip(kernel_res, want_res, strict=True):
        assert got_r.dtype == want_r.dtype and _scaled_err(got_r.float(), want_r.float()) <= tol
    got_layers, want_layers = unpack_params(grad), unpack_params(want_grad)
    for name, (w, b) in want_layers.items():
        assert _scaled_err(got_layers[name][0], w) <= tol, name
        assert _scaled_err(got_layers[name][1], b) <= tol, name
    assert ddc.shape == (n, 64) and _scaled_err(ddc, want_ddc) <= tol


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
def test_train_backward_is_deterministic(model, compute_dtype):
    for n, s in ((1024, 128), (41, 50)):
        pts, dc, params, g = _train_case(model, n, s, compute_dtype, seed=5)
        _, res = flex_train_fwd(pts, dc, params, compute_dtype)
        a = flex_train_bwd(g, res, params, n, s, compute_dtype)
        b = flex_train_bwd(g, res, params, n, s, compute_dtype)
        torch.cuda.synchronize()
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]), (n, s)


def test_train_function_goes_through_both_kernels(model):
    """The autograd entry point: one forward and one backward launch per
    evaluation, gradients on every parameter, none on pts or viewdirs."""
    pts, vd = _inputs(64, 32, seed=7)
    pts.requires_grad_(True)
    vd.requires_grad_(True)
    fwd0, bwd0 = fused_flex_mlp_train.fwd_launches, fused_flex_mlp_train.bwd_launches
    model.zero_grad()
    fused_flex_mlp_train(model, pts, vd).square().sum().backward()
    got = {k: p.grad.clone() for k, p in model.named_parameters()}
    assert (fused_flex_mlp_train.fwd_launches, fused_flex_mlp_train.bwd_launches) == (
        fwd0 + 1, bwd0 + 1)
    assert pts.grad is None and vd.grad is None
    model.zero_grad()
    mlp_t_plain(model, pts.detach(), vd.detach()).square().sum().backward()
    for name, p in model.named_parameters():
        assert _scaled_err(got[name], p.grad) <= 1e-4, name


@pytest.fixture
def paper_model():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card (see module docstring)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return PaperNeRFModel(num_encoding_fn_xyz=10, generator=torch.Generator().manual_seed(0)
                          ).cuda().eval()


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", TC_FWD_TOL)])
@pytest.mark.parametrize("n,s", [(1, 1), (33, 64), (1000, 128), (7, 61), (333, 48), (100, 100)])
def test_paper_kernel_matches_plain(paper_model, n, s, compute_dtype, tol):
    """(333, 48) and (100, 100): samples that do not divide the bf16 body's
    64-point slabs, so a slab's dc rows span rays; all end mid-tile."""
    pts, vd = _inputs(n, s, seed=n * s)
    fused = paper_t.fused_paper_mlp_t
    before = (fused.launches, fused.wgmma_launches)
    with torch.inference_mode():
        got = fused(paper_model, pts, vd, compute_dtype)
        torch.cuda.synchronize()
        want = paper_t.paper_t_plain(paper_model, pts, vd, compute_dtype)
    bf16 = compute_dtype == "bfloat16"
    assert (fused.launches, fused.wgmma_launches) == (before[0] + 1, before[1] + bf16)
    assert got.shape == (n, s, 4) and got.is_cuda
    assert float((got - want).abs().max()) <= tol


def test_paper_kernel_takes_any_encoding_depth():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc; run on the card (see module docstring)")
    pts, vd = _inputs(40, 16, seed=3)
    for f in (0, 4, 6, 16):
        model = PaperNeRFModel(num_encoding_fn_xyz=f, generator=torch.Generator().manual_seed(f))
        model = model.cuda()
        with torch.inference_mode():
            got = paper_t.fused_paper_mlp_t(model, pts, vd)
            want = paper_t.paper_t_plain(model, pts, vd)
        assert float((got - want).abs().max()) <= 1e-4, f


def _check_paper_train_pair(model, n, s, compute_dtype, tol, f=10):
    """#9's forward (output and residuals) against the plain forward, its
    backward against the plain backward on the forward kernel's residuals,
    two backward calls bitwise equal; one forward and two backward launches,
    the backward's weight gradients on the wgmma body in bf16 only."""
    pts, vd = _inputs(n, s, seed=n * s + f)
    gen = torch.Generator(device="cuda").manual_seed(n)
    g = torch.randn(n, s, 4, generator=gen, device="cuda")
    params = paper_t.pack_params(model).detach()
    dc = paper_t.dir_contribution(model, vd).detach()
    fused = paper_train.fused_paper_mlp_train
    fwd0, bwd0, wg0 = fused.fwd_launches, fused.bwd_launches, fused.wgmma_bwd_launches
    out, res = paper_train.paper_train_fwd(pts, dc, params, compute_dtype, f)
    grad, ddc = paper_train.paper_train_bwd(g, res, params, n, s, compute_dtype, f)
    again = paper_train.paper_train_bwd(g, res, params, n, s, compute_dtype, f)
    torch.cuda.synchronize()
    assert (fused.fwd_launches, fused.bwd_launches) == (fwd0 + 1, bwd0 + 2)
    assert fused.wgmma_bwd_launches == wg0 + 2 * (compute_dtype == "bfloat16")
    assert torch.equal(grad, again[0]) and torch.equal(ddc, again[1])    # deterministic
    want, want_res = paper_train.paper_train_plain_fwd(pts, dc, params, compute_dtype, f)
    kernel_res = paper_train.residuals_as_plain(res, n * s, f, compute_dtype)
    want_grad, want_ddc = paper_train.paper_train_plain_bwd(g, kernel_res, params, n, s,
                                                            compute_dtype, f)
    assert float((out - want).abs().max()) <= min(tol, TC_FWD_TOL)
    for got_r, want_r in zip(kernel_res, want_res, strict=True):
        assert got_r.dtype == want_r.dtype and _scaled_err(got_r.float(), want_r.float()) <= tol
    got_layers = paper_t.unpack_params(grad, f)
    for name, (w, b) in paper_t.unpack_params(want_grad, f).items():
        assert _scaled_err(got_layers[name][0], w) <= tol, name
        assert _scaled_err(got_layers[name][1], b) <= tol, name
    assert ddc.shape == (n, 128) and _scaled_err(ddc, want_ddc) <= tol


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-4), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("n,s", [(1, 1), (33, 64), (1024, 128), (7, 61)])
def test_paper_train_kernels_match_plain(paper_model, n, s, compute_dtype, tol):
    _check_paper_train_pair(paper_model, n, s, compute_dtype, tol)


@pytest.mark.parametrize("f", [0, 6, 10, 16])
@pytest.mark.parametrize("n,s", [(7, 61), (333, 61), (41, 50), (1000, 131)])
def test_paper_bf16_kernels_match_plain_at_any_depth(paper_model, f, n, s):
    """The tensor-core (bf16) #4 and #9 at every K padding of the encoding:
    3 + 6F -> 16, 48, 64, 112. Every count ends mid-tile; (333, 61) in a
    last chunk of 30 of 32 tiles, (41, 50) in a 2-point tile alone in its
    chunk, (1000, 131) mid-stage of the weight gradients' 32-point stages, in
    a last chunk of 31 tiles, with 1,600 work items for the SMs to walk."""
    model = PaperNeRFModel(num_encoding_fn_xyz=f,
                           generator=torch.Generator().manual_seed(f)).cuda().eval()
    pts, vd = _inputs(n, s, seed=f)
    with torch.inference_mode():
        got = paper_t.fused_paper_mlp_t(model, pts, vd, "bfloat16")
        torch.cuda.synchronize()
        want = paper_t.paper_t_plain(model, pts, vd, "bfloat16")
    assert float((got - want).abs().max()) <= TC_FWD_TOL
    with torch.no_grad():
        _check_paper_train_pair(model, n, s, "bfloat16", 2e-2, f)


@pytest.mark.parametrize("f", [0, 6, 16])
@pytest.mark.parametrize("n,s", [(7, 61), (333, 61), (41, 50)])
def test_paper_f32_kernels_match_plain_at_any_depth(paper_model, f, n, s):
    """The f32 #4 and #9 (paper_mlp.cuh's register-blocked body, the
    weight-gradient pass's 128 x 128 tiles) at encoding depths whose enc
    rows end mid-slice (3 + 6F = 3, 39, 99). (333, 61) ends mid-tile with a
    last chunk of 30 of kTilesPerChunk = 32 tiles; (41, 50) is 33 tiles, the
    last of 2 points alone in its chunk."""
    model = PaperNeRFModel(num_encoding_fn_xyz=f,
                           generator=torch.Generator().manual_seed(f)).cuda().eval()
    pts, vd = _inputs(n, s, seed=f + 1)
    with torch.inference_mode():
        got = paper_t.fused_paper_mlp_t(model, pts, vd, "float32")
        torch.cuda.synchronize()
        want = paper_t.paper_t_plain(model, pts, vd, "float32")
    assert float((got - want).abs().max()) <= 1e-4
    with torch.no_grad():
        _check_paper_train_pair(model, n, s, "float32", 1e-4, f)


@pytest.mark.parametrize("n,s", [(41, 50), (1024, 128)])
def test_paper_f32_kernels_repeat_bitwise(paper_model, n, s):
    """Two calls of the f32 #4, #9's forward (output and residuals) and #9's
    backward (gradient and ddc) give bitwise-equal results."""
    pts, vd = _inputs(n, s, seed=n + s)
    g = torch.randn(n, s, 4, generator=torch.Generator(device="cuda").manual_seed(5),
                    device="cuda")
    params = paper_t.pack_params(paper_model).detach()
    dc = paper_t.dir_contribution(paper_model, vd).detach()

    def run():
        out, res = paper_train.paper_train_fwd(pts, dc, params, "float32", 10)
        grad, ddc = paper_train.paper_train_bwd(g, res, params, n, s, "float32", 10)
        return paper_t.fused_paper_mlp_t(paper_model, pts, vd, "float32"), out, res[0], grad, ddc

    with torch.no_grad():
        first, again = run(), run()
        torch.cuda.synchronize()
    for name, a, b in zip(("#4", "#9 out", "#9 residuals", "#9 grad", "#9 ddc"), first, again):
        assert torch.equal(a, b), name


def test_paper_bf16_dead_layer_gets_a_zero_gradient(paper_model):
    pts, vd = _inputs(64, 32, seed=8)
    for p in paper_model.parameters():
        p.grad = torch.zeros_like(p)
    paper_train.fused_paper_mlp_train(paper_model, pts, vd, "bfloat16").square().sum().backward()
    assert not bool(paper_model.layers_dir[3].weight.grad.any())
    assert not bool(paper_model.layers_dir[3].bias.grad.any())
    assert bool(paper_model.layers_dir[2].weight.grad.any())


def test_paper_train_function_goes_through_both_kernels(paper_model):
    pts, vd = _inputs(64, 32, seed=7)
    fused = paper_train.fused_paper_mlp_train
    fwd0, bwd0 = fused.fwd_launches, fused.bwd_launches
    for p in paper_model.parameters():
        p.grad = torch.zeros_like(p)
    fused(paper_model, pts, vd).square().sum().backward()
    got = {k: p.grad.clone() for k, p in paper_model.named_parameters()}
    assert (fused.fwd_launches, fused.bwd_launches) == (fwd0 + 1, bwd0 + 1)
    assert not bool(got["layers_dir.3.weight"].any())
    paper_model.zero_grad()
    paper_t.paper_t_plain(paper_model, pts, vd).square().sum().backward()
    for name, p in paper_model.named_parameters():
        if p.grad is not None:
            assert _scaled_err(got[name], p.grad) <= 1e-4, name


def test_renderer_goes_through_the_paper_kernels(paper_model):
    gen = torch.Generator(device="cuda").manual_seed(3)
    ro = torch.randn(300, 3, generator=gen, device="cuda") * 0.1 + torch.tensor(
        [0.0, 0.0, 4.0], device="cuda")
    rd = torch.randn(300, 3, generator=gen, device="cuda") * 0.2 - torch.tensor(
        [0.0, 0.0, 1.0], device="cuda")
    settings = renderer.RenderSettings(num_coarse=32, num_fine=0, perturb=False,
                                       white_background=True, num_encoding_fn_xyz=10,
                                       num_encoding_fn_dir=4, use_pallas=True)
    before = paper_t.fused_paper_mlp_t.launches
    with torch.inference_mode():
        fused = renderer.render_rays(paper_model, None, ro, rd, settings)
        plain = renderer.render_rays(paper_model, None, ro, rd,
                                     dataclasses.replace(settings, use_pallas=False))
    assert paper_t.fused_paper_mlp_t.launches == before + 1
    assert float((fused.rgb - plain.rgb).abs().max()) <= 1e-4


def _ray_case(n, s, seed):
    """Points, viewdirs, sorted depths in [2, 6] and un-normalized directions."""
    pts, vd = _inputs(n, s, seed)
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    z = torch.sort(2.0 + 4.0 * torch.rand(n, s, generator=gen, device="cuda"), dim=-1)[0]
    return pts, vd, z, vd * (1.0 + torch.rand(n, 1, generator=gen, device="cuda"))


def _map_errs(got, want):
    return {k: float((got[k] - want[k]).abs().max()) for k in want}


@pytest.mark.parametrize("white_background", [False, True])
def test_composite_kernel_matches_plain(model, white_background):
    _, _, z, rd = _ray_case(333, 61, seed=1)
    gen = torch.Generator(device="cuda").manual_seed(2)
    rf = torch.randn(333, 61, 4, generator=gen, device="cuda") * 2
    before = composite.fused_volume_render.launches
    got = composite.fused_volume_render(rf, z, rd, white_background)
    again = composite.fused_volume_render(rf, z, rd, white_background)
    torch.cuda.synchronize()
    assert composite.fused_volume_render.launches == before + 2
    assert all(torch.equal(got[k], again[k]) for k in got)
    errs = _map_errs(got, composite.volume_render_plain(rf, z, rd, white_background))
    assert max(errs["rgb"], errs["acc"], errs["weights"]) <= 1e-5 and errs["depth"] <= 1e-4, errs


def test_resample_kernel_matches_plain(model):
    _, _, z, _ = _ray_case(333, 62, seed=3)
    gen = torch.Generator(device="cuda").manual_seed(4)
    w = torch.rand(333, 61, generator=gen, device="cuda")
    w[0] = 0.0
    u = torch.rand(333, 61, generator=gen, device="cuda")
    u[1, 0] = 1.0
    before = resample.fused_sample_pdf.launches
    for kw in ({"det": True}, {"u": u}):
        got = resample.fused_sample_pdf(z, w, 61, **kw)
        again = resample.fused_sample_pdf(z, w, 61, **kw)
        torch.cuda.synchronize()
        assert torch.equal(got, again)
        # Uniform weights keep the pdfs far from the 1e-5 guard; a prefix sum
        # in another order moves a sample by ~ulp * width / pdf (the JAX
        # package's atol for its own kernel, tests/test_pallas_resample.py).
        assert float((got - resample.sample_pdf(z, w, 61, **kw)).abs().max()) <= 2e-4
    assert resample.fused_sample_pdf.launches == before + 4


@pytest.mark.parametrize("m", [2, 65, 129, 768])
def test_resample_kernel_scans_every_segment(model, m):
    """Bin counts at the warp scan's edges: one term, a second 64-term
    segment begun, three segments, the largest M. Against sample_pdf on the
    CPU, whose torch.cumsum accumulates in f64 as the kernel's scan does."""
    gen = torch.Generator().manual_seed(m)
    z = torch.sort(2.0 + 4.0 * torch.rand(97, m, generator=gen), dim=-1)[0]
    w = torch.rand(97, m - 1, generator=gen)
    w[0] = 0.0
    u = torch.rand(97, 64, generator=gen)
    u[:, 0], u[:, 1] = 1.0, 0.0
    got = resample.fused_sample_pdf(z.cuda(), w.cuda(), 64, u=u.cuda())
    torch.cuda.synchronize()
    assert float((got.cpu() - resample.sample_pdf(z, w, 64, u=u)).abs().max()) <= 2e-4


@pytest.mark.parametrize("compute_dtype,tol", [("float32", 1e-5), ("bfloat16", 2e-2)])
def test_stage_kernel_matches_plain(model, compute_dtype, tol):
    pts, vd, z, rd = _ray_case(333, 61, seed=5)
    before = stage.fused_render_stage.launches
    with torch.inference_mode():
        got = stage.fused_render_stage(model, pts, vd, z, rd, True, compute_dtype)
        again = stage.fused_render_stage(model, pts, vd, z, rd, True, compute_dtype)
        torch.cuda.synchronize()
        want = stage.render_stage_plain(model, pts, vd, z, rd, True, compute_dtype)
    assert stage.fused_render_stage.launches == before + 2
    assert all(torch.equal(got[k], again[k]) for k in got)
    errs = _map_errs(got, want)
    assert max(errs["rgb"], errs["acc"], errs["weights"]) <= tol, errs


@pytest.mark.parametrize("white_background", [False, True])
@pytest.mark.parametrize("n,s", [(1, 1), (64, 64), (333, 61), (9, 600)])
def test_stage_bf16_is_composite_of_the_tensor_core_field(model, n, s, white_background):
    """#7's bf16 instance runs the mma.sync tile per point and #5's scan per
    ray, at any S (a block's tiles straddle rays at S = 61): its maps are
    bitwise those of #5 on #1's bf16 field (the wgmma body, which sums in
    the tile's order)."""
    pts, vd, z, rd = _ray_case(n, s, seed=n + s)
    with torch.inference_mode():
        got = stage.fused_render_stage(model, pts, vd, z, rd, white_background, "bfloat16")
        want = composite.fused_volume_render(fused_mlp_t(model, pts, vd, "bfloat16"), z, rd,
                                             white_background)
        torch.cuda.synchronize()
    assert all(torch.equal(got[k], want[k]) for k in want)


# The f32 4x128 forwards share flex_mlp.cuh's register-blocked body, which
# stages weights in slices of 32 rows (64 at the direction layer's width).
# Point counts that end mid-tile and mid-slice: 37 x 45 = 26 tiles and 1
# point, 3 x 7 = one partial tile, 129 x 33 (a stage block's tiles straddle
# rays). Map tolerances as chip_smoke.py's MAP_TOLS.
F32_MAP_TOLS = {"rgb": 1e-5, "acc": 1e-5, "weights": 1e-5, "depth": 1e-4, "disp": 1e-4}


def _f32_forwards(model, pts, vd, z, rd):
    """name -> a call of the f32 instance of #1, #2, #3, #7 and #8's forward."""
    n, s = pts.shape[:2]
    flat_pts, flat_vd = pts.reshape(-1, 3), vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
    dc, params = dir_contribution(model, vd), pack_params(model)
    return {
        "#1": lambda: fused_mlp_t(model, pts, vd, "float32"),
        "#2": lambda: mlp.fused_flexible_mlp(model, flat_pts, flat_vd, "float32"),
        "#3": lambda: mlp.fused_flexible_mlp_rays(model, pts, vd, "float32"),
        "#7": lambda: stage.fused_render_stage(model, pts, vd, z, rd, True, "float32"),
        "#8": lambda: flex_train_fwd(pts, dc, params, "float32"),
    }


@pytest.mark.parametrize("n,s", [(37, 45), (3, 7), (129, 33)])
def test_f32_forwards_match_plain_at_ragged_counts(model, n, s):
    """Each f32 instance against its plain version: #1-#3 and #8's output to
    1e-4, #8's residuals to 1e-4 of the plain one's largest entry, #7's maps
    to F32_MAP_TOLS; #3 bitwise #1."""
    pts, vd, z, rd = _ray_case(n, s, seed=n * s)
    with torch.inference_mode():
        got = {name: fn() for name, fn in _f32_forwards(model, pts, vd, z, rd).items()}
        torch.cuda.synchronize()
        flat_vd = vd[:, None, :].expand(n, s, 3).reshape(-1, 3)
        want = {
            "#1": mlp_t_plain(model, pts, vd, "float32"),
            "#2": mlp.flexible_mlp_plain(model, pts.reshape(-1, 3), flat_vd, "float32"),
            "#3": mlp.flexible_mlp_rays_plain(model, pts, vd, "float32"),
        }
        maps = stage.render_stage_plain(model, pts, vd, z, rd, True, "float32")
        plain_out, plain_res = flex_train_plain_fwd(pts, dir_contribution(model, vd),
                                                    pack_params(model), "float32")
    for name, w in want.items():
        assert float((got[name] - w).abs().max()) <= 1e-4, name
    errs = _map_errs(got["#7"], maps)
    assert all(errs[k] <= F32_MAP_TOLS[k] for k in errs), errs
    out, res = got["#8"]
    assert float((out - plain_out).abs().max()) <= 1e-4
    for got_r, want_r in zip(residuals_as_plain(res, n * s), plain_res, strict=True):
        assert _scaled_err(got_r, want_r) <= 1e-4
    assert torch.equal(got["#3"], got["#1"])


@pytest.mark.parametrize("n,s", [(37, 45), (2048, 128)])
def test_f32_forwards_repeat_bitwise(model, n, s):
    """Two launches of each f32 instance give bitwise-equal outputs (#8's
    residuals included)."""
    pts, vd, z, rd = _ray_case(n, s, seed=n + 1)
    calls = _f32_forwards(model, pts, vd, z, rd)
    with torch.inference_mode():
        first = {name: fn() for name, fn in calls.items()}
        again = {name: fn() for name, fn in calls.items()}
        torch.cuda.synchronize()
    for name in calls:
        a, b = first[name], again[name]
        if name == "#7":
            assert all(torch.equal(a[k], b[k]) for k in a), name
        elif name == "#8":
            assert torch.equal(a[0], b[0]) and torch.equal(a[1][0], b[1][0]), name
        else:
            assert torch.equal(a, b), name


def test_new_kernels_refuse_what_they_do_not_take(model):
    pts, vd, z, rd = _ray_case(4, 8, seed=6)
    rf = torch.zeros(4, 8, 4, device="cuda")
    with pytest.raises(ValueError, match="float32"):
        composite.fused_volume_render(rf.double(), z, rd)
    with pytest.raises(ValueError, match="want depths"):
        composite.fused_volume_render(rf, z[:, :5], rd)
    with pytest.raises(ValueError, match="float32"):
        resample.fused_sample_pdf(z.double(), z[:, 1:].double(), 4, det=True)
    with pytest.raises(ValueError, match="want bins"):
        resample.fused_sample_pdf(z, z, 4, det=True)
    with pytest.raises(ValueError, match="want u"):
        resample.fused_sample_pdf(z, z[:, 1:], 4, u=torch.rand(4, 5, device="cuda"))
    with pytest.raises(ValueError, match="float32"):
        stage.fused_render_stage(model, pts.double(), vd.double(), z, rd)
    with pytest.raises(ValueError, match="want depths"):
        stage.fused_render_stage(model, pts, vd, z[:3], rd)


# --- the scene axis of #8 and #9 -------------------------------------------


def _scene_case(family, scenes, n, s, f, seed):
    """Stacked inputs of #8's ("flex") or #9's ("paper") pair on ``scenes``
    scenes, each with its own seeded model, points and cotangent."""
    mod = paper_t if family == "paper" else mlp
    cases = []
    for i in range(scenes):
        gen = torch.Generator().manual_seed(seed + i)
        m = (PaperNeRFModel(num_encoding_fn_xyz=f, generator=gen) if family == "paper"
             else FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4, generator=gen))
        m = m.cuda()
        pts, vd = _inputs(n, s, seed=seed + i)
        g = torch.randn(n, s, 4, generator=torch.Generator(device="cuda").manual_seed(seed - i),
                        device="cuda")
        cases.append((pts, mod.dir_contribution(m, vd).detach(), mod.pack_params(m).detach(), g))
    return cases


def _scene_fns(family, f):
    if family == "paper":
        return (lambda *a: paper_train.paper_train_fwd_scenes(*a, f),
                lambda *a: paper_train.paper_train_bwd_scenes(*a, f),
                lambda *a: paper_train.paper_train_fwd(*a, f),
                lambda *a: paper_train.paper_train_bwd(*a, f),
                paper_train.fused_paper_mlp_train)
    from nerf_tpu_torch.kernels import flex_train

    return (flex_train.flex_train_fwd_scenes, flex_train.flex_train_bwd_scenes, flex_train_fwd,
            flex_train_bwd, fused_flex_mlp_train)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family,scenes,n,s,f", [
    ("flex", 3, 333, 61, 10), ("flex", 2, 1024, 128, 10), ("flex", 1, 41, 50, 10),
    ("flex", 4, 7, 61, 10), ("paper", 3, 333, 61, 10), ("paper", 2, 41, 50, 6),
    ("paper", 1, 1024, 64, 10), ("paper", 2, 7, 61, 16), ("paper", 6, 333, 61, 0),
    ("paper", 6, 41, 50, 6), ("paper", 6, 7, 61, 16)])
def test_scene_batched_pair_is_the_single_scene_launches(model, family, scenes, n, s, f,
                                                         compute_dtype):
    """One forward and one backward launch for all scenes; each scene's
    output, residuals, gradient and ddc bitwise a single-scene launch's on
    its inputs. N·P odd or ending mid-tile (333 x 61, 7 x 61), a 3-chunk
    run (41 x 50), one scene; #9 at six scenes at depths 0, 6 and 16. A
    bf16 Paper backward runs its weight gradients on the wgmma body."""
    cases = _scene_case(family, scenes, n, s, f, seed=n + s)
    fwd_scenes, bwd_scenes, fwd, bwd, fused = _scene_fns(family, f)
    pts, dc, params, g = (torch.stack(x) for x in zip(*cases))
    fwd0, bwd0 = fused.fwd_launches, fused.bwd_launches
    wg0 = getattr(fused, "wgmma_bwd_launches", 0)
    out, res = fwd_scenes(pts, dc, params, compute_dtype)
    grad, ddc = bwd_scenes(g, res, params, compute_dtype)
    torch.cuda.synchronize()
    assert (fused.fwd_launches, fused.bwd_launches) == (fwd0 + 1, bwd0 + 1)
    wgmma = family == "paper" and compute_dtype == "bfloat16"
    assert getattr(fused, "wgmma_bwd_launches", 0) == wg0 + wgmma
    assert bool(torch.isfinite(out).all() and torch.isfinite(grad).all())
    for i, (p_, d_, w_, g_) in enumerate(cases):
        o1, r1 = fwd(p_, d_, w_, compute_dtype)
        g1, d1 = bwd(g_, r1, w_, n, s, compute_dtype)
        torch.cuda.synchronize()
        assert torch.equal(out[i], o1) and torch.equal(res[0][i], r1[0]), i
        assert torch.equal(grad[i], g1) and torch.equal(ddc[i], d1), i


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("family", ["flex", "paper"])
def test_vmapped_training_field_launches_once_for_all_scenes(model, family, compute_dtype):
    """Under torch.func.vmap over stacked parameters the autograd entry
    point launches one forward and one backward for the scenes; each scene
    against its model alone: the output to 1e-6 (f32) or TC_FWD_TOL (bf16;
    the direction term's host matmul runs batched), gradients within the
    same of each leaf's largest."""
    scenes, n, s = 3, 64, 32
    cls = PaperNeRFModel if family == "paper" else FlexibleNeRFModel
    models = [cls(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                  generator=torch.Generator().manual_seed(i)).cuda() for i in range(scenes)]
    fused = _scene_fns(family, 10)[4]
    pts, vd = (torch.stack(x) for x in zip(*(_inputs(n, s, seed=i) for i in range(scenes))))
    cot = torch.randn(scenes, n, s, 4, generator=torch.Generator(device="cuda").manual_seed(9),
                      device="cuda")
    names = [k for k, _ in models[0].named_parameters()]
    leaves = {k: torch.stack([dict(m.named_parameters())[k].detach() for m in models])
              .requires_grad_(True) for k in names}
    template = cls(num_encoding_fn_xyz=10, num_encoding_fn_dir=4).cuda()

    class Field(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = template

        def forward(self, x, v):
            return fused(self.model, x, v, compute_dtype)

    field = Field()
    fwd0, bwd0 = fused.fwd_launches, fused.bwd_launches
    out = torch.func.vmap(lambda p, x, v: torch.func.functional_call(
        field, {f"model.{k}": t for k, t in p.items()}, (x, v)))(leaves, pts, vd)
    (out * cot).sum().backward()
    torch.cuda.synchronize()
    assert (fused.fwd_launches, fused.bwd_launches) == (fwd0 + 1, bwd0 + 1)
    tol = 1e-6 if compute_dtype == "float32" else TC_FWD_TOL
    for i, m in enumerate(models):
        want = fused(m, pts[i], vd[i], compute_dtype)
        (want * cot[i]).sum().backward()
        assert float((out[i] - want).abs().max()) <= tol, i
        for k, p in m.named_parameters():
            got = leaves[k].grad
            if p.grad is None:                # #9's dead layers_dir.3
                assert got is None or not bool(got[i].any()), k
                continue
            assert _scaled_err(got[i], p.grad) <= (1e-5 if compute_dtype == "float32"
                                                   else 2e-2), (i, k)

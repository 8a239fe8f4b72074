"""The bf16 weight buffers and residual layouts of the tensor-core 4x128 kernels (#1-#3, #7, #8).

The bf16 instances of ``fused_mlp_t``, ``fused_render_stage``,
``fused_flexible_mlp``, ``fused_flexible_mlp_rays`` and
``fused_flex_mlp_train`` read their weights as
bf16 copies that the wrappers build once per call
(``kernels/mlp.IMAGES``' ``tc_forward``, ``tc_forward_points`` for the
point-major kernel, ``tc_backward``) in the order of
the ``mma.sync`` m16n8k16 B fragments of a 4-warp block, each K padded to a
multiple of 16 with zero rows (layer 1's 63 -> 64, the direction rows' 27 ->
32, drgb . W_rgb's 3 -> 16, the fused head's 129 -> 144). The kernels run
only on the card (tests/test_torch_cuda.py); here:

- the 4-warp fragment order is the PTX layout of the B operand, element by
  element; #1's bf16 instance reads instead the
  ``kernels/mlp.IMAGES.wg_forward`` image (``csrc/flex_wg.cuh``): its wide
  layers as the 128-byte-swizzled 64-column K slices wgmma's descriptors
  read, checked element by element,
  unpacking to the same rounded weights, of the length the C layout counts,
  and a plain pass from it bitwise ``mlp_t_plain``'s;
- each buffer unpacks to round_bf16(W) of the model's nn.Linear weights
  exactly, its pads zero; the point-major buffer is the forward buffer
  followed by layers_dir.0's direction rows;
- the plain forward and backward computed from the unpacked weights equal
  the bf16 plain passes (``flex_train_plain_fwd`` / ``_bwd``,
  ``mlp_t_plain``, ``flexible_mlp_plain``) bitwise; the ray-major pass from
  the forward buffer (the ray-major kernel's bf16 weights since it runs
  #1's tile) is ``mlp_t_plain``'s bf16 pass bitwise;
- at a small shape, the plain forward in f32 from those weights against the
  JAX package's ``fused_mlp_t``, ``fused_flex_mlp_train`` and
  ``fused_flexible_mlp`` in Pallas interpret mode on the JAX parameters rounded to bf16, with
  tests/test_torch_flex_train.py's tolerance (2e-4: the JAX kernels'
  double-angle sinusoids), against ``fused_flexible_mlp_rays`` with
  tests/test_torch_mlp.py's (1e-4), and the plain backward in f32 from the backward
  buffer's weights against JAX's XLA autodiff of the rounded model, each of
  the 16 leaves to 2e-5 of its largest entry (tests/test_torch_paper_tc.py's
  tolerance: fc_alpha's bias gradient is one sum of 520 cotangents, 1.5e-5
  apart in the two summation orders; JAX's CPU backend has no bf16
  x bf16 -> f32 dot, so JAX runs in f32 on weights that are bf16 values);
- ``residuals_as_plain`` reads both residual layouts the forward kernel
  writes (f32 res[tile][row][point], bf16 res[point][row] with enc padded to
  64) back as the plain forward's residuals.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine import renderer as jrend
from nerf_tpu.models import FlexibleNeRFModel as JaxFlexible
from nerf_tpu.ops.pallas.flex_train import fused_flex_mlp_train as jax_flex_train
from nerf_tpu.ops.pallas.mlp import fused_flexible_mlp as jax_flexible_mlp
from nerf_tpu.ops.pallas.mlp import fused_flexible_mlp_rays as jax_flexible_mlp_rays
from nerf_tpu.ops.pallas.mlp_t import fused_mlp_t as jax_mlp_t
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.kernels.common import fragment_matrix, fragment_order
from nerf_tpu_torch.kernels.flex_train import (
    flex_train_plain_bwd,
    flex_train_plain_fwd,
    residuals_as_plain,
)
from nerf_tpu_torch.kernels.mlp import (
    IMAGES,
    dir_contribution,
    flexible_mlp_plain,
    flexible_mlp_rays_plain,
    pack_params,
    pack_params_points,
    unpack_params,
)
from nerf_tpu_torch.kernels.mlp_t import mlp_t_plain
from nerf_tpu_torch.models import FlexibleNeRFModel

torch.set_num_threads(1)
LAYERS = ("layer1", "layers_xyz.0", "layers_xyz.1", "layers_xyz.2", "fc_feat", "fc_alpha",
          "layers_dir.0", "fc_rgb")


def _r(w):
    return w.detach().bfloat16().float()


def _model(seed):
    return FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4,
                             generator=torch.Generator().manual_seed(seed))


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, s, 4)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True), cot


@pytest.mark.parametrize("n", [64, 128])
def test_fragment_order_is_the_mma_b_layout_of_a_4_warp_block(n):
    """m16n8k16 .col B fragment of lane l: b0, b1 = B[k = 2 (l % 4) + {0, 1}][n = l // 4],
    b2, b3 the same at k + 8; warp w owns N / 4 outputs, NT = N / 32 tiles of 8."""
    k = 48
    m = torch.arange(n * k, dtype=torch.float64).view(n, k)
    flat = fragment_order(m, warps=4)
    nt = n // 32
    i = 0
    for ks in range(k // 16):
        for warp in range(4):
            for lane in range(32):
                for j in range(nt):
                    for e in range(4):
                        row = (warp * nt + j) * 8 + lane // 4
                        col = ks * 16 + 8 * (e // 2) + 2 * (lane % 4) + e % 2
                        assert flat[i] == m[row, col], (ks, warp, lane, j, e)
                        i += 1
    assert i == flat.numel()
    assert torch.equal(fragment_matrix(flat, n, k, warps=4), m)


@pytest.mark.parametrize("seed", [0, 1])
def test_forward_buffer_unpacks_to_the_rounded_weights(seed):
    model = _model(seed)
    buf = IMAGES.tc_forward.pack(pack_params(model))
    assert buf.dtype == torch.bfloat16 and buf.numel() == IMAGES.tc_forward.size == 82240
    mats = IMAGES.tc_forward.unpack(buf)
    assert list(mats) == ["layer1", "layers_xyz.0", "layers_xyz.1", "layers_xyz.2", "fc_feat",
                          "layers_dir.0", "fc_alpha", "fc_rgb"]
    w1 = mats["layer1"]
    assert w1.shape == (128, 64)
    assert torch.equal(w1[:, :63], _r(model.layer1.weight)) and not w1[:, 63:].any()
    for i in range(3):
        assert torch.equal(mats[f"layers_xyz.{i}"], _r(model.layers_xyz[i].weight))
    assert torch.equal(mats["fc_feat"], _r(model.fc_feat.weight))
    assert torch.equal(mats["layers_dir.0"], _r(model.layers_dir[0].weight[:, :128]))
    assert torch.equal(mats["fc_alpha"], _r(model.fc_alpha.weight))
    assert torch.equal(mats["fc_rgb"], _r(model.fc_rgb.weight))


@pytest.mark.parametrize("seed", [0, 1])
def test_backward_buffer_unpacks_to_the_rounded_weights(seed):
    model = _model(seed)
    buf = IMAGES.tc_backward.pack(pack_params(model))
    assert buf.dtype == torch.bfloat16 and buf.numel() == 76800
    mats = IMAGES.tc_backward.unpack(buf)
    rgb = mats["fc_rgb"]
    assert rgb.shape == (64, 16)
    assert torch.equal(rgb[:, :3], _r(model.fc_rgb.weight.t())) and not rgb[:, 3:].any()
    assert torch.equal(mats["layers_dir.0"], _r(model.layers_dir[0].weight[:, :128].t()))
    head = mats["head"]
    assert head.shape == (128, 144)
    assert torch.equal(head[:, :128], _r(model.fc_feat.weight.t()))
    assert torch.equal(head[:, 128:129], _r(model.fc_alpha.weight.t()))
    assert not head[:, 129:].any()
    for i in range(3):
        assert torch.equal(mats[f"layers_xyz.{i}"], _r(model.layers_xyz[i].weight.t()))


@pytest.mark.parametrize("seed", [0, 1])
def test_points_buffer_is_the_forward_buffer_then_the_rounded_direction_rows(seed):
    model = _model(seed)
    params = pack_params_points(model)
    assert params.numel() == 84548
    buf = IMAGES.tc_forward_points.pack(params)
    assert buf.dtype == torch.bfloat16 and buf.numel() == 82240 + 64 * 32
    assert torch.equal(buf[:82240], IMAGES.tc_forward.pack(pack_params(model)))
    mats = IMAGES.tc_forward_points.unpack(buf)
    assert list(mats)[-1] == "dir_rows"
    dirs = mats["dir_rows"]
    assert dirs.shape == (64, 32)
    assert torch.equal(dirs[:, :27], _r(model.layers_dir[0].weight[:, 128:]))
    assert not dirs[:, 27:].any()
    rest = IMAGES.tc_forward.unpack(buf[:82240])
    assert all(torch.equal(mats[k], v) for k, v in rest.items())


def _with_forward_weights(model, image=IMAGES.tc_forward):
    """A copy of ``model`` whose forward weights are those of its bf16
    forward buffer (``image``, packed and read back)."""
    mats = image.unpack(image.pack(pack_params(model)))
    out = copy.deepcopy(model)
    with torch.no_grad():
        out.layer1.weight.copy_(mats["layer1"][:, :63])
        for i in range(3):
            out.layers_xyz[i].weight.copy_(mats[f"layers_xyz.{i}"])
        out.fc_feat.weight.copy_(mats["fc_feat"])
        out.layers_dir[0].weight[:, :128] = mats["layers_dir.0"]
        out.fc_alpha.weight.copy_(mats["fc_alpha"])
        out.fc_rgb.weight.copy_(mats["fc_rgb"])
    return out


def _with_points_weights(model):
    """``_with_forward_weights`` with layers_dir.0's direction rows those of
    the point-major buffer too."""
    mats = IMAGES.tc_forward_points.unpack(IMAGES.tc_forward_points.pack(pack_params_points(model)))
    out = _with_forward_weights(model)
    with torch.no_grad():
        out.layers_dir[0].weight[:, 128:] = mats["dir_rows"][:, :27]
    return out


def _with_backward_weights(model):
    """A copy of ``model`` whose weights in the bf16 backward buffer are that
    buffer's (layer1, not in it, stays)."""
    mats = IMAGES.tc_backward.unpack(IMAGES.tc_backward.pack(pack_params(model)))
    out = copy.deepcopy(model)
    with torch.no_grad():
        out.fc_rgb.weight.copy_(mats["fc_rgb"][:, :3].t())
        out.layers_dir[0].weight[:, :128] = mats["layers_dir.0"].t()
        out.fc_feat.weight.copy_(mats["head"][:, :128].t())
        out.fc_alpha.weight.copy_(mats["head"][:, 128:129].t())
        for i in range(3):
            out.layers_xyz[i].weight.copy_(mats[f"layers_xyz.{i}"].t())
    return out


@pytest.mark.parametrize("n,s", [(1, 1), (7, 9), (3, 61)])
def test_plain_pass_from_the_buffers_is_bitwise_the_bf16_plain_pass(n, s):
    model = _model(n + s)
    pts, vd, cot = (torch.from_numpy(a) for a in _inputs(n, s, seed=n * s))
    params = pack_params(model).detach()
    with torch.no_grad():
        dc = dir_contribution(model, vd)
        fwd_model = _with_forward_weights(model)
        want, want_res = flex_train_plain_fwd(pts, dc, params, "bfloat16")
        got, got_res = flex_train_plain_fwd(pts, dc, pack_params(fwd_model), "bfloat16")
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_res, want_res, strict=True))
        assert torch.equal(flexible_mlp_rays_plain(fwd_model, pts, vd, "bfloat16"),
                           flexible_mlp_rays_plain(model, pts, vd, "bfloat16"))
        want_grad, want_ddc = flex_train_plain_bwd(cot, want_res, params, n, s, "bfloat16")
        got_grad, got_ddc = flex_train_plain_bwd(
            cot, want_res, pack_params(_with_backward_weights(model)), n, s, "bfloat16")
    assert torch.equal(got_grad, want_grad) and torch.equal(got_ddc, want_ddc)


@pytest.mark.parametrize("n", [1, 65, 300])
def test_point_major_plain_pass_from_the_points_buffer_is_bitwise_the_bf16_plain_pass(n):
    model = _model(n)
    rng = np.random.default_rng(n)
    pts = torch.from_numpy(rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32))
    vd = torch.from_numpy(rng.normal(size=(n, 3)).astype(np.float32))
    vd = vd / torch.linalg.norm(vd, dim=-1, keepdim=True)
    with torch.no_grad():
        got = flexible_mlp_plain(_with_points_weights(model), pts, vd, "bfloat16")
        want = flexible_mlp_plain(model, pts, vd, "bfloat16")
    assert torch.equal(got, want)


@pytest.mark.parametrize("s", [1, 61, 128])
def test_ray_major_plain_pass_from_the_forward_buffer_is_bitwise_mlp_t(s):
    """#3's bf16 kernel runs the mma.sync tile on the tc_forward buffer:
    the ray-major plain pass on the buffer's weights is mlp_t's plain bf16
    pass, bit for bit, at a ray-major layout (R, S) whose tiles start
    mid-ray."""
    model = _model(s)
    pts, vd, _ = (torch.from_numpy(a) for a in _inputs(7, s, seed=s))
    with torch.no_grad():
        got = flexible_mlp_rays_plain(_with_forward_weights(model), pts, vd, "bfloat16")
        want = mlp_t_plain(model, pts, vd, "bfloat16")
    assert got.shape == (7, s, 4)
    assert torch.equal(got, want)


# The wide layers of #1's wgmma image (csrc/flex_wg.cuh), (out, in) with
# layer1's K padded to 64, at their offsets.
WG_WIDE = (("layer1", 128, 64, 0), ("layers_xyz.0", 128, 128, 8192),
           ("layers_xyz.1", 128, 128, 24576), ("layers_xyz.2", 128, 128, 40960),
           ("fc_feat", 128, 128, 57344), ("layers_dir.0", 64, 128, 73728))


def test_wg_image_is_the_swizzled_slice_layout():
    """csrc/flex_wg.cuh's resident image: each wide layer's K in 64-column
    slices of N rows of 128 bytes, column k of row n at 16-byte chunk
    (k % 64 // 8) ^ (n % 8), as wgmma's 128-byte-swizzle descriptor reads a
    K-major operand; fc_alpha and fc_rgb follow plain. Checked on the
    image's gather index: each value's position in pack_params' buffer (one
    past its end for layer1's zero column)."""
    index = IMAGES.wg_forward.index("cpu")
    layers = unpack_params(torch.arange(82820 + 1, dtype=torch.float64))
    for name, n, k, off in WG_WIDE:
        w = layers[name][0].t()[:n]                      # (out, in) positions
        w = torch.nn.functional.pad(w, (0, k - w.shape[1]), value=82820.0)
        for row in range(n):
            for col in range(k):
                at = (off + (col // 64) * n * 64 + row * 64 + ((col % 64 // 8) ^ (row % 8)) * 8
                      + col % 8)
                assert index[at] == w[row, col], (name, row, col)
    tail = torch.cat([layers["fc_alpha"][0].t().reshape(-1), layers["fc_rgb"][0].t().reshape(-1)])
    assert torch.equal(index[81920:].double(), tail)


@pytest.mark.parametrize("seed", [0, 1])
def test_wg_buffer_unpacks_to_the_rounded_weights(seed):
    """#1's wgmma image holds the same matrices as the tensor-core forward
    buffer: round_bf16(W), layer1's pad column zero."""
    model = _model(seed)
    buf = IMAGES.wg_forward.pack(pack_params(model))
    assert buf.dtype == torch.bfloat16 and buf.numel() == IMAGES.wg_forward.size
    assert buf.data_ptr() % 16 == 0
    mats = IMAGES.wg_forward.unpack(buf)
    want = IMAGES.tc_forward.unpack(IMAGES.tc_forward.pack(pack_params(model)))
    assert list(mats) == list(want)
    assert all(torch.equal(mats[k], v) for k, v in want.items())
    w1 = mats["layer1"]
    assert torch.equal(w1[:, :63], _r(model.layer1.weight)) and not w1[:, 63:].any()


def test_wg_weight_count_is_the_c_layout():
    """csrc/flex_wg.cuh kNumWeights (the card's nerf_mlp_t_wg_weights, which
    kernels/mlp_t._kernel holds to this count): nine 128 x 64 slices
    (layer1 one, the four 128-wide layers two each), two 64 x 64 slices of
    the direction layer, then fc_alpha (128) and fc_rgb (3 x 64)."""
    assert IMAGES.wg_forward.size == 9 * 128 * 64 + 2 * 64 * 64 + 128 + 3 * 64 == 82240
    assert sum(n * k for _, n, k, _ in WG_WIDE) == 81920


@pytest.mark.parametrize("s", [48, 64, 128])
def test_plain_pass_from_the_wg_buffer_is_bitwise_mlp_t(s):
    """#1's bf16 pass on its wgmma image's weights is mlp_t_plain's bf16
    pass, bit for bit."""
    model = _model(s + 3)
    pts, vd, _ = (torch.from_numpy(a) for a in _inputs(5, s, seed=s + 3))
    with torch.no_grad():
        wg_model = _with_forward_weights(model, IMAGES.wg_forward)
        got = mlp_t_plain(wg_model, pts, vd, "bfloat16")
        want = mlp_t_plain(model, pts, vd, "bfloat16")
    assert got.shape == (5, s, 4)
    assert torch.equal(got, want)


def _rounded(tree):
    """JAX params with every kernel rounded to bf16 (biases kept)."""
    if isinstance(tree, dict):
        return {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
                if k == "kernel" else _rounded(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rounded(v) for v in tree)
    return tree


def _flagship():
    return FlexibleNeRFModel(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)


@pytest.fixture(scope="module")
def jax_pair():
    jmodel = JaxFlexible(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(_flagship(), params)
    rounded = _rounded(params)
    # The rounded model with its weights replaced by the buffers' own: if a
    # buffer held a wrong weight, this model would no longer be JAX's.
    base = load_jax_params(_flagship(), rounded)
    fwd, bwd = _with_points_weights(tmodel), _with_backward_weights(tmodel)
    with torch.no_grad():
        for (name, p), q in zip(base.named_parameters(), fwd.parameters()):
            if "weight" in name:
                p.copy_(q)
    return jmodel, rounded, base, bwd


def _plain_forward(base, pts, vd):
    with torch.no_grad():
        vd_t = torch.from_numpy(vd)
        return flex_train_plain_fwd(torch.from_numpy(pts), dir_contribution(base, vd_t),
                                    pack_params(base), "float32")


def test_forward_from_the_buffer_matches_the_jax_kernel(jax_pair):
    _, rounded, base, _ = jax_pair
    pts, vd, _ = _inputs(33, 8, seed=11)
    want = np.asarray(jax_mlp_t(rounded, jnp.asarray(pts), jnp.asarray(vd), interpret=True))
    got = _plain_forward(base, pts, vd)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


def test_point_major_forward_from_the_points_buffer_matches_the_jax_kernel(jax_pair):
    """flexible_mlp_plain in f32 on the rounded model whose weights, the 27
    direction rows included, are the points buffer's own, against JAX's
    point-major kernel in interpret mode on the rounded parameters."""
    _, rounded, base, _ = jax_pair
    rng = np.random.default_rng(17)
    n = 300                                           # not a multiple of the JAX tile (256)
    pts = rng.uniform(-1.3, 1.3, (n, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    vd /= np.linalg.norm(vd, axis=-1, keepdims=True)
    want = np.asarray(jax_flexible_mlp(rounded, jnp.asarray(pts), jnp.asarray(vd), tile=256,
                                       interpret=True))
    with torch.no_grad():
        got = flexible_mlp_plain(base, torch.from_numpy(pts), torch.from_numpy(vd), "float32")
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.mark.parametrize("s", [1, 61, 128])
def test_ray_major_forward_from_the_buffer_matches_the_jax_kernel(jax_pair, s):
    """flexible_mlp_rays_plain in f32 on the rounded model whose weights are
    the forward buffer's own, against JAX's ray-major kernel in interpret
    mode on the rounded parameters; 20 rays, not a multiple of 16 a tile."""
    _, rounded, base, _ = jax_pair
    pts, vd, _ = _inputs(20, s, seed=19 + s)
    want = np.asarray(jax_flexible_mlp_rays(rounded, jnp.asarray(pts), jnp.asarray(vd),
                                            rays_per_tile=16, interpret=True))
    with torch.no_grad():
        got = flexible_mlp_rays_plain(base, torch.from_numpy(pts), torch.from_numpy(vd),
                                      "float32")
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def test_forward_from_the_buffer_matches_the_jax_training_kernel(jax_pair):
    _, rounded, base, _ = jax_pair
    pts, vd, _ = _inputs(40, 8, seed=13)
    want = np.asarray(jax_flex_train(rounded, jnp.asarray(pts), jnp.asarray(vd),
                                     interpret=True))
    got = _plain_forward(base, pts, vd)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-4, atol=2e-4)


@pytest.fixture(scope="module")
def backward_pair(jax_pair):
    """XLA autodiff's gradients of the rounded model and the plain backward's
    from the backward buffer's weights, both as the packed layout's leaves."""
    jmodel, rounded, base, bwd = jax_pair
    n, s = 65, 8
    pts, vd, cot = _inputs(n, s, seed=0)
    settings = jrend.RenderSettings(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    enc = jrend.encode_points(jnp.asarray(pts), jnp.asarray(vd), settings)
    grads = jax.grad(lambda p: jnp.sum(jmodel.apply(p, enc) * cot))(rounded)
    want = unpack_params(pack_params(load_jax_params(
        _flagship(), jax.tree_util.tree_map(np.asarray, grads))))
    _, res = _plain_forward(base, pts, vd)
    with torch.no_grad():
        # The backward's weights from the bf16 backward buffer: bwd holds
        # those of the unrounded model, the rounded model's by construction.
        got = unpack_params(flex_train_plain_bwd(torch.from_numpy(cot), res, pack_params(bwd),
                                                 n, s, "float32")[0])
    return got, want


@pytest.mark.parametrize("leaf", [(name, i) for name in LAYERS for i in (0, 1)],
                         ids=lambda x: f"{x[0]}.{'weight' if x[1] == 0 else 'bias'}")
def test_backward_from_the_buffer_matches_jax_autodiff(backward_pair, leaf):
    got, want = backward_pair
    name, i = leaf
    a, ref = got[name][i].detach(), want[name][i].detach()
    assert a.shape == ref.shape
    scale = max(float(ref.abs().max()), 1e-3)
    np.testing.assert_allclose(a.numpy() / scale, ref.numpy() / scale, atol=2e-5)


def _kernel_layout(residuals, compute_dtype):
    """The plain residuals (P, C) as the forward kernel writes them: f32
    res[tile][row][point] (767 rows), bf16 res[point][row] (768 rows, enc
    padded to 64); the ragged last tile's points past P hold garbage."""
    p = residuals[0].shape[0]
    tiles = -(-p // 64)
    enc, rest = residuals[0], torch.cat(residuals[1:], dim=1)
    if compute_dtype == "bfloat16":
        table = torch.full((tiles * 64, 768), 7.0, dtype=torch.bfloat16)
        table[:p, :63], table[:p, 63], table[:p, 64:] = enc, 0.0, rest
        return table.reshape(-1)
    table = torch.full((tiles * 64, 767), 7.0)
    table[:p] = torch.cat([enc, rest], dim=1)
    return table.view(tiles, 64, 767).transpose(1, 2).reshape(-1)


@pytest.mark.parametrize("compute_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("n,s", [(1, 1), (3, 61), (2, 64)])
def test_residuals_as_plain_reads_both_kernel_layouts(compute_dtype, n, s):
    model = _model(3)
    pts, vd, _ = (torch.from_numpy(a) for a in _inputs(n, s, seed=5))
    with torch.no_grad():
        _, residuals = flex_train_plain_fwd(pts, dir_contribution(model, vd),
                                            pack_params(model), compute_dtype)
    got = residuals_as_plain((_kernel_layout(residuals, compute_dtype),), n * s, compute_dtype)
    assert [tuple(g.shape) for g in got] == [tuple(r.shape) for r in residuals]
    assert all(g.dtype == r.dtype and torch.equal(g, r)
               for g, r in zip(got, residuals, strict=True))
    assert residuals_as_plain(residuals, n * s, compute_dtype) == tuple(residuals)

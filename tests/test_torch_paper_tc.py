"""The bf16 weight buffers of the tensor-core PaperNeRF kernels (#4, #9).

The bf16 instances of ``fused_paper_mlp_t`` and ``fused_paper_mlp_train``
read their weights as bf16 copies that the wrappers build once per call:
#9's (``kernels/paper_t.images(f)``' ``tc_forward`` and ``tc_backward``)
in the order of the ``mma.sync`` m16n8k16 B fragments, #4's
(``wg_forward``) as the swizzled shared-memory images of
its wgmma kernel's 64-column K slices; each K padded to a multiple of 16 with
zero rows. The kernels themselves run only on the card
(tests/test_torch_cuda.py); here, at encoding depths 0, 6, 10 and 16 (K pads
3 -> 16, 39 -> 48, 63 -> 64, 99 -> 112, and 319 -> 320 at the skip):

- the fragment order is the PTX layout of the B operand, element by element,
  and the slice images the 128-byte swizzle, element by element; the image's
  length is csrc/paper_wg.cuh's;
- each buffer unpacks to round_bf16(W) of the model's nn.Linear weights
  exactly, its pads zero;
- the plain forward and backward computed from the unpacked weights equal
  ``paper_plain_forward`` and ``paper_train_plain_bwd`` at bf16 bitwise;
- at a small shape, the plain forward in f32 from those weights against the
  JAX package's ``fused_paper_mlp_t`` and ``fused_paper_mlp_train`` in Pallas
  interpret mode on the JAX parameters rounded to bf16, with
  tests/test_torch_paper.py's tolerance (5e-4; the JAX kernels' double-angle
  sinusoids); and the plain backward in f32 from those weights against JAX's
  XLA autodiff of the rounded model (sin/cos both), with
  tests/test_torch_paper_train.py's tolerance (2e-5 of each leaf's largest
  entry). The interpret kernel's own gradients are not the yardstick there:
  on bf16-valued weights its sinusoids flip ReLU masks of these small sums,
  and its layers_xyz.0 gradient lies 1.5% (scaled) from XLA autodiff's at
  this seed (ROADMAP.md §3 records the same at f32 weights, seed 2). JAX's CPU
  backend has no bf16 x bf16 -> f32 dot, so JAX runs in f32 on weights that
  are bf16 values.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu.engine import renderer as jrend
from nerf_tpu.models import PaperNeRFModel as JaxPaper
from nerf_tpu.ops.pallas.paper_t import fused_paper_mlp_t as jax_paper_t
from nerf_tpu.ops.pallas.paper_train import fused_paper_mlp_train as jax_paper_train
from nerf_tpu_torch.engine.checkpoint import load_jax_params
from nerf_tpu_torch.kernels.common import fragment_matrix, fragment_order, swizzled, unswizzled
from nerf_tpu_torch.kernels.paper_t import (
    dir_contribution,
    images,
    pack_params,
    paper_plain_forward,
    unpack_params,
)
from nerf_tpu_torch.kernels.paper_train import paper_train_plain_bwd, paper_train_plain_fwd
from nerf_tpu_torch.models import PaperNeRFModel

torch.set_num_threads(1)
FREQS = [0, 6, 10, 16]


def _r(w):
    return w.detach().bfloat16().float()


def _model(f):
    return PaperNeRFModel(num_encoding_fn_xyz=f, generator=torch.Generator().manual_seed(f + 1))


def _inputs(n, s, seed):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-1.3, 1.3, (n, s, 3)).astype(np.float32)
    vd = rng.normal(size=(n, 3)).astype(np.float32)
    cot = rng.normal(size=(n, s, 4)).astype(np.float32)
    return pts, vd / np.linalg.norm(vd, axis=-1, keepdims=True), cot


def test_fragment_order_is_the_mma_b_layout():
    """m16n8k16 .col B fragment of lane l: b0, b1 = B[k = 2 (l % 4) + {0, 1}][n = l // 4],
    b2, b3 the same at k + 8; warp w owns N / 8 outputs, NT = N / 64 tiles of 8."""
    n, k = 128, 48
    m = torch.arange(n * k, dtype=torch.float64).view(n, k)
    flat = fragment_order(m)
    nt = n // 64
    i = 0
    for ks in range(k // 16):
        for warp in range(8):
            for lane in range(32):
                for j in range(nt):
                    for e in range(4):
                        row = (warp * nt + j) * 8 + lane // 4
                        col = ks * 16 + 8 * (e // 2) + 2 * (lane % 4) + e % 2
                        assert flat[i] == m[row, col], (ks, warp, lane, j, e)
                        i += 1
    assert i == flat.numel()
    assert torch.equal(fragment_matrix(flat, n, k), m)


def test_wg_image_is_the_swizzled_slice_layout():
    """csrc/paper_wg.cuh's ring slices: K in 64-column slices (the last
    padded), each N rows of 128 bytes whose 16-byte chunks are swizzled,
    column k of row n at chunk (k // 8) ^ (n % 8), as TMA's and wgmma's
    128-byte swizzle lays a K-major operand out."""
    n, k = 24, 100
    m = torch.arange(n * k, dtype=torch.float64).view(n, k)
    flat = swizzled(m, -1.0)
    assert flat.numel() == n * 128
    for row in range(n):
        for col in range(128):
            got = flat[(col // 64) * n * 64 + row * 64 + ((col % 64 // 8) ^ (row % 8)) * 8
                       + col % 8]
            assert got == (m[row, col] if col < k else -1.0), (row, col)
    assert torch.equal(unswizzled(flat, n, k), m)


def _unpack_forward(buf, f, name="tc_forward"):
    """The forward image ``name`` at depth ``f`` as operand matrices, layer
    4 whole (the wgmma image holds its encoding rows and h rows apart)."""
    mats = getattr(images(f), name).unpack(buf)
    if name == "wg_forward":
        mats["layers_xyz.4"] = torch.cat([mats.pop("layers_xyz.4.enc"),
                                          mats.pop("layers_xyz.4.h")], 1)
    return mats


def _check_forward_weights(mats, model, f):
    """The forward operand matrices ``mats`` (name -> (out, in) with the K
    pads to 16) hold round_bf16 of ``model``'s weights, their pads zero."""
    dim, kin = 3 + 6 * f, -(-(3 + 6 * f) // 16) * 16
    for i in range(8):
        w, got = model.layers_xyz[i].weight, mats[f"layers_xyz.{i}"]
        if i == 0:
            assert got.shape == (256, kin)
            assert torch.equal(got[:, :dim], _r(w)) and not got[:, dim:].any()
        elif i == 4:
            assert got.shape == (256, kin + 256)
            assert torch.equal(got[:, :dim], _r(w[:, :dim])) and not got[:, dim:kin].any()
            assert torch.equal(got[:, kin:], _r(w[:, dim:]))
        else:
            assert torch.equal(got, _r(w))
    assert torch.equal(mats["fc_feat"], _r(model.fc_feat.weight))
    assert torch.equal(mats["layers_dir.0"], _r(model.layers_dir[0].weight[:, :256]))
    for i in (1, 2):
        assert torch.equal(mats[f"layers_dir.{i}"], _r(model.layers_dir[i].weight))
    assert torch.equal(mats["fc_alpha"], _r(model.fc_alpha.weight))
    assert torch.equal(mats["fc_rgb"], _r(model.fc_rgb.weight))


@pytest.mark.parametrize("f", FREQS)
def test_forward_buffer_unpacks_to_the_rounded_weights(f):
    model = _model(f)
    buf = images(f).tc_forward.pack(pack_params(model))
    assert buf.dtype == torch.bfloat16 and buf.numel() == images(f).tc_forward.size
    _check_forward_weights(_unpack_forward(buf, f), model, f)


@pytest.mark.parametrize("f", FREQS)
def test_wg_buffer_unpacks_to_the_rounded_weights(f):
    """The wgmma render forward's image unpacks to the same matrices (its
    slices' pads beyond the 16-column ones checked zero by the unpacking)."""
    model = _model(f)
    buf = images(f).wg_forward.pack(pack_params(model))
    assert buf.dtype == torch.bfloat16 and buf.numel() == images(f).wg_forward.size
    assert buf.data_ptr() % 16 == 0
    _check_forward_weights(_unpack_forward(buf, f, "wg_forward"), model, f)


@pytest.mark.parametrize("f", FREQS)
def test_wg_weight_count_is_the_c_layouts(f):
    """csrc/paper_wg.cuh num_weights: (2 enc_slices + 32) wide slices of
    256 x 64, 8 narrow ones of 128 x 64 (layers_dir.0: 4, .1, .2: 2 each),
    then fc_alpha (256) and fc_rgb (3 x 128); enc_slices = ceil(pad16(dim) /
    64): 1 at F <= 10, 2 at F = 16."""
    kin = -(-(3 + 6 * f) // 16) * 16
    enc_slices = -(-kin // 64)
    want = (2 * enc_slices + 32) * 256 * 64 + 8 * 128 * 64 + 256 + 3 * 128
    assert images(f).wg_forward.size == want
    assert want == (656000 if f == 16 else 623232)


@pytest.mark.parametrize("f", FREQS)
def test_backward_buffer_unpacks_to_the_rounded_weights(f):
    model = _model(f)
    dim = 3 + 6 * f
    buf = images(f).tc_backward.pack(pack_params(model))
    assert buf.dtype == torch.bfloat16 and buf.numel() == 595968
    mats = images(f).tc_backward.unpack(buf)
    rgb = mats["fc_rgb"]
    assert rgb.shape == (128, 16)
    assert torch.equal(rgb[:, :3], _r(model.fc_rgb.weight.t())) and not rgb[:, 3:].any()
    for i in (1, 2):
        assert torch.equal(mats[f"layers_dir.{i}"], _r(model.layers_dir[i].weight.t()))
    head = mats["head"]
    assert head.shape == (256, 144)
    assert torch.equal(head[:, :128], _r(model.layers_dir[0].weight[:, :256].t()))
    assert torch.equal(head[:, 128:129], _r(model.fc_alpha.weight.t()))
    assert not head[:, 129:].any()
    assert torch.equal(mats["fc_feat"], _r(model.fc_feat.weight.t()))
    for i in range(1, 8):
        w = model.layers_xyz[i].weight
        assert torch.equal(mats[f"layers_xyz.{i}"], _r((w[:, dim:] if i == 4 else w).t()))


def _with_forward_weights(model, f, name="tc_forward"):
    """A copy of ``model`` whose forward weights are those of its bf16
    forward image ``name``, packed and read back."""
    dim, kin = 3 + 6 * f, -(-(3 + 6 * f) // 16) * 16
    mats = _unpack_forward(getattr(images(f), name).pack(pack_params(model)), f, name)
    out = copy.deepcopy(model)
    with torch.no_grad():
        for i in range(8):
            w = mats[f"layers_xyz.{i}"]
            w = w[:, :dim] if i == 0 else torch.cat([w[:, :dim], w[:, kin:]], 1) if i == 4 else w
            out.layers_xyz[i].weight.copy_(w)
        out.fc_feat.weight.copy_(mats["fc_feat"])
        out.layers_dir[0].weight[:, :256] = mats["layers_dir.0"]
        for i in (1, 2):
            out.layers_dir[i].weight.copy_(mats[f"layers_dir.{i}"])
        out.fc_alpha.weight.copy_(mats["fc_alpha"])
        out.fc_rgb.weight.copy_(mats["fc_rgb"])
    return out


@pytest.mark.parametrize("f", FREQS)
def test_plain_pass_from_the_wg_buffer_is_bitwise_the_bf16_plain_pass(f):
    model = _model(f)
    pts, vd, _ = (torch.from_numpy(a) for a in _inputs(7, 9, seed=f + 20))
    with torch.no_grad():
        dc = dir_contribution(model, vd)
        want = paper_plain_forward(pts, dc, pack_params(model).detach(), f, "bfloat16",
                                   residuals=False)[0]
        wg_model = _with_forward_weights(model, f, "wg_forward")
        got = paper_plain_forward(pts, dc, pack_params(wg_model), f, "bfloat16",
                                  residuals=False)[0]
    assert torch.equal(got, want)


def _with_backward_weights(model, f):
    """A copy of ``model`` whose weights in the bf16 backward buffer are that
    buffer's (layers_xyz.0 and layer 4's enc rows, not in it, stay)."""
    dim = 3 + 6 * f
    mats = images(f).tc_backward.unpack(images(f).tc_backward.pack(pack_params(model)))
    out = copy.deepcopy(model)
    with torch.no_grad():
        out.fc_rgb.weight.copy_(mats["fc_rgb"][:, :3].t())
        for i in (1, 2):
            out.layers_dir[i].weight.copy_(mats[f"layers_dir.{i}"].t())
        out.layers_dir[0].weight[:, :256] = mats["head"][:, :128].t()
        out.fc_alpha.weight.copy_(mats["head"][:, 128:129].t())
        out.fc_feat.weight.copy_(mats["fc_feat"].t())
        for i in range(1, 8):
            w = mats[f"layers_xyz.{i}"].t()
            if i == 4:
                out.layers_xyz[4].weight[:, dim:] = w
            else:
                out.layers_xyz[i].weight.copy_(w)
    return out


@pytest.mark.parametrize("f", FREQS)
def test_plain_pass_from_the_buffers_is_bitwise_the_bf16_plain_pass(f):
    model = _model(f)
    pts, vd, cot = (torch.from_numpy(a) for a in _inputs(7, 9, seed=f))
    params = pack_params(model).detach()
    with torch.no_grad():
        dc = dir_contribution(model, vd)
        want, want_res = paper_plain_forward(pts, dc, params, f, "bfloat16")
        got, got_res = paper_plain_forward(pts, dc, pack_params(_with_forward_weights(model, f)),
                                           f, "bfloat16")
        assert torch.equal(got, want)
        assert all(torch.equal(a, b) for a, b in zip(got_res, want_res, strict=True))
        _, res = paper_train_plain_fwd(pts, dc, params, "bfloat16", f)
        want_grad, want_ddc = paper_train_plain_bwd(cot, res, params, 7, 9, "bfloat16", f)
        got_grad, got_ddc = paper_train_plain_bwd(
            cot, res, pack_params(_with_backward_weights(model, f)), 7, 9, "bfloat16", f)
    assert torch.equal(got_grad, want_grad) and torch.equal(got_ddc, want_ddc)


def _rounded(tree):
    """JAX params with every kernel rounded to bf16 (biases kept)."""
    if isinstance(tree, dict):
        return {k: np.asarray(jnp.asarray(v).astype(jnp.bfloat16).astype(jnp.float32))
                if k == "kernel" else _rounded(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_rounded(v) for v in tree)
    return tree


@pytest.fixture(scope="module")
def jax_pair():
    jmodel = JaxPaper(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    params = jmodel.init(jax.random.PRNGKey(0))
    tmodel = load_jax_params(PaperNeRFModel(num_encoding_fn_xyz=10), params)
    rounded = _rounded(params)
    # The rounded model with its weights replaced by the buffers' own: if a
    # buffer held a wrong weight, this model would no longer be JAX's.
    base = load_jax_params(PaperNeRFModel(num_encoding_fn_xyz=10), rounded)
    fwd, bwd = _with_forward_weights(tmodel, 10), _with_backward_weights(tmodel, 10)
    with torch.no_grad():
        for (name, p), q in zip(base.named_parameters(), fwd.parameters()):
            if "weight" in name and "layers_dir.0" not in name and "layers_dir.3" not in name:
                p.copy_(q)
        base.layers_dir[0].weight[:, :256] = fwd.layers_dir[0].weight[:, :256]
    return rounded, base, bwd


def test_forward_from_the_buffer_matches_the_jax_kernel(jax_pair):
    rounded, base, _ = jax_pair
    pts, vd, _ = _inputs(33, 8, seed=11)
    want = np.asarray(jax_paper_t(rounded, jnp.asarray(pts), jnp.asarray(vd), num_freq_xyz=10,
                                  interpret=True))
    with torch.no_grad():
        vd_t = torch.from_numpy(vd)
        got = paper_plain_forward(torch.from_numpy(pts), dir_contribution(base, vd_t),
                                  pack_params(base), 10, residuals=False)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_forward_from_the_buffer_matches_the_jax_training_kernel(jax_pair):
    rounded, base, _ = jax_pair
    pts, vd, _ = _inputs(40, 8, seed=13)
    want = np.asarray(jax_paper_train(rounded, jnp.asarray(pts), jnp.asarray(vd),
                                      num_freq_xyz=10, interpret=True))
    with torch.no_grad():
        got = paper_train_plain_fwd(torch.from_numpy(pts),
                                    dir_contribution(base, torch.from_numpy(vd)),
                                    pack_params(base), "float32", 10)[0]
    np.testing.assert_allclose(got.numpy(), want, rtol=5e-4, atol=5e-4)


def test_backward_from_the_buffer_matches_jax_autodiff(jax_pair):
    rounded, base, bwd = jax_pair
    n, s = 65, 8
    pts, vd, cot = _inputs(n, s, seed=0)
    jmodel = JaxPaper(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    settings = jrend.RenderSettings(num_encoding_fn_xyz=10, num_encoding_fn_dir=4)
    enc = jrend.encode_points(jnp.asarray(pts), jnp.asarray(vd), settings)
    grads = jax.grad(lambda p: jnp.sum(jmodel.apply(p, enc) * cot))(rounded)
    want = unpack_params(pack_params(load_jax_params(PaperNeRFModel(num_encoding_fn_xyz=10),
                                                     jax.tree_util.tree_map(np.asarray, grads))),
                         10)
    with torch.no_grad():
        vd_t = torch.from_numpy(vd)
        _, res = paper_train_plain_fwd(torch.from_numpy(pts), dir_contribution(base, vd_t),
                                       pack_params(base), "float32", 10)
        # The backward's weights from the bf16 backward buffer: bwd holds
        # those of the unrounded model, the rounded model's by construction.
        got = unpack_params(paper_train_plain_bwd(torch.from_numpy(cot), res, pack_params(bwd),
                                                  n, s, "float32", 10)[0], 10)
    for name, (w, b) in want.items():
        for leaf, a, ref in (("weight", got[name][0], w), ("bias", got[name][1], b)):
            scale = max(float(ref.detach().abs().max()), 1e-3)
            np.testing.assert_allclose(a.numpy() / scale, ref.detach().numpy() / scale,
                                       atol=2e-5, err_msg=f"{name}.{leaf}")

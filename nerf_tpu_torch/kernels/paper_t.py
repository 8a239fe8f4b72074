"""Fused encode + MLP radiance-field evaluation of the 8x256 PaperNeRF.

Replaces ``nerf_tpu/ops/pallas/paper_t.py:fused_paper_mlp_t`` with a
hand-written CUDA kernel for Hopper (``csrc/paper_t.cu``, device code in
``csrc/paper_mlp.cuh``): (N, S, 3) points + (N, 3) viewdirs -> (N, S, 4) raw
[r, g, b, sigma] f32, with the positional encoding, the 8-layer trunk and its
skip at layer 4, fc_feat, sigma (read from feat), the three live direction
layers and fc_rgb in one launch whose activations stay in shared memory and
registers. The encoding depth is the model's ``num_encoding_fn_xyz``, a
runtime argument of the kernel (0 to 16).

What bounds it on the card is arithmetic: 622,720 multiply-adds a point at
10 frequencies against 28 B of point traffic. ``compute_dtype="float32"``
runs f32 FMAs from registers; ``"bfloat16"`` runs every wide product on the
tensor cores (``wgmma``, bf16 operands, f32 sums; ``csrc/paper_wg.cuh``), its
weights handed over as a bf16 image of the kernel's shared-memory ring
stages (``images(f).wg_forward``), built once per call. ``tc_forward`` packs
the same weights in ``mma.sync`` fragment order for #9's bf16 training
forward (``csrc/paper_tc.cuh``). ``images`` declares the family's four
weight images, #9's backward's among them; ``kernels/common.WeightImage``
packs them.

Like the TPU version, the per-ray direction contribution
``enc(viewdirs) @ W_dir[:, 256:].T`` (N, 128) is computed outside the kernel
with one matmul and added to each sample's layers_dir.0 pre-activation inside.

``compute_dtype="bfloat16"`` rounds both operands of every matmul to bf16 and
keeps f32 sums, as the TPU kernel does (``preferred_element_type=f32``). The
plain version emulates exactly that with ``.bfloat16().float()`` and f32
matmuls.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, NamedTuple, Tuple

import torch

from ..models.mlp import PaperNeRFModel
from ..ops.encoding import positional_encoding
from .common import (
    Fragments,
    Rows,
    Swizzled,
    WeightImage,
    aligned,
    check_forward,
    check_rc,
    cuda_stream,
    f32_matmul,
    rounder,
)

_WIDTH = 256
_DIR_WIDTH = 128
_MAX_FREQ = 16             # encoding depths the kernels take (csrc/paper_mlp.cuh kMaxFreq)


def supports_fused_paper(model) -> bool:
    """True when ``model`` is a PaperNeRF shape the kernels fuse (the gate of
    ``nerf_tpu/ops/pallas/paper_t.py:supports_fused_paper``: the encoding
    depth is free, within the kernels' 0..16)."""
    return (
        isinstance(model, PaperNeRFModel)
        and model.use_viewdirs
        and model.include_input_xyz
        and model.include_input_dir
        and len(model.layers_xyz) == 8
        and len(model.layers_dir) == 4
        and tuple(model.layers_xyz[1].weight.shape) == (_WIDTH, _WIDTH)
        and 0 <= model.num_encoding_fn_xyz <= _MAX_FREQ
    )


def dir_contribution(model: PaperNeRFModel, viewdirs: torch.Tensor) -> torch.Tensor:
    """Per-ray ``enc(viewdirs) @ W_dir[:, 256:].T``: (N, 3) -> (N, 128) f32,
    in full f32 on the card (``f32_matmul``: TF32 off for this product and
    its gradient only)."""
    direnc = positional_encoding(viewdirs.float(), model.num_encoding_fn_dir)
    return f32_matmul(direnc, model.layers_dir[0].weight[:, _WIDTH:].float().t())


def _pad4(n: int) -> int:
    return -(-n // 4) * 4


def layout(num_freq: int) -> List[Tuple[str, int, int]]:
    """The packed parameter buffer's layers, in order: (name, in, out); each
    (in, out) weight and its (out,) bias are padded to a multiple of 4 floats
    (``csrc/paper_mlp.cuh`` ``make_layout``)."""
    dim = 3 + 6 * num_freq
    out = [(f"layers_xyz.{i}", dim if i == 0 else dim + _WIDTH if i == 4 else _WIDTH, _WIDTH)
           for i in range(8)]
    out += [("fc_feat", _WIDTH, _WIDTH), ("fc_alpha", _WIDTH, 1),
            ("layers_dir.0", _WIDTH, _DIR_WIDTH), ("layers_dir.1", _DIR_WIDTH, _DIR_WIDTH),
            ("layers_dir.2", _DIR_WIDTH, _DIR_WIDTH), ("fc_rgb", _DIR_WIDTH, 3)]
    return out


def num_params(num_freq: int) -> int:
    """Floats in the packed parameter buffer at encoding depth ``num_freq``."""
    return sum(_pad4(i * o) + _pad4(o) for _, i, o in layout(num_freq))


def pack_params(model: PaperNeRFModel) -> torch.Tensor:
    """The kernels' parameter buffer: each layer's (in, out) weight, then its
    bias, zero-padded, in ``layout``'s order. layers_dir.0 contributes its
    feat rows only. Differentiable: a ``torch.cat`` of the parameters."""
    parts = []
    for name, i, o in layout(model.num_encoding_fn_xyz):
        layer = model.get_submodule(name)
        w = layer.weight[:, :_WIDTH] if name == "layers_dir.0" else layer.weight
        for x in (w.t().reshape(-1), layer.bias):
            parts.append(x.float())
            if _pad4(x.numel()) != x.numel():
                parts.append(torch.zeros(_pad4(x.numel()) - x.numel(), device=x.device))
    return torch.cat(parts)


def unpack_params(params: torch.Tensor, num_freq: int
                  ) -> Dict[str, Tuple[torch.Tensor, torch.Tensor]]:
    """Views of the packed buffer: name -> (weight (in, out), bias (out,))."""
    out, off = {}, 0
    for name, i, o in layout(num_freq):
        w = params[off:off + i * o].view(i, o)
        off += _pad4(i * o)
        out[name] = (w, params[off:off + o])
        off += _pad4(o)
    return out


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def _tc_forward_matrices(layers, dim: int, pad) -> List[Tuple[str, torch.Tensor]]:
    """The tensor-core forward's operands, in ``csrc/paper_tc.cuh``'s
    FwdLayout order: each wide layer as (out, in) with K padded to 16 by
    ``pad`` (layers_xyz.4: [enc rows, pad, h rows]), then fc_alpha (1, 256)
    and fc_rgb (3, 128), read plain."""
    kin = _pad16(dim)
    mats = []
    for i in range(8):
        w = layers[f"layers_xyz.{i}"][0].t()
        if i == 0:
            w = torch.nn.functional.pad(w, (0, kin - dim), value=pad)
        elif i == 4:
            enc_rows = torch.nn.functional.pad(w[:, :dim], (0, kin - dim), value=pad)
            w = torch.cat([enc_rows, w[:, dim:]], dim=1)
        mats.append((f"layers_xyz.{i}", w))
    return mats + [(name, layers[name][0].t()) for name in (
        "fc_feat", "layers_dir.0", "layers_dir.1", "layers_dir.2", "fc_alpha", "fc_rgb")]


def _wg_matrices(layers, dim: int, pad) -> List[Tuple[str, torch.Tensor]]:
    """The wgmma kernel's operands in the order its ring reads them: the
    tensor-core forward's matrices (``_tc_forward_matrices``) with layer 4
    cut into its encoding rows and its h rows (each starts a slice)."""
    mats = _tc_forward_matrices(layers, dim, pad)
    kin = mats[0][1].shape[1]
    out = []
    for name, m in mats:
        if name == "layers_xyz.4":
            out += [(f"{name}.enc", m[:, :kin]), (f"{name}.h", m[:, kin:])]
        else:
            out.append((name, m))
    return out


def _tc_backward_matrices(layers, dim: int, pad) -> List[Tuple[str, torch.Tensor]]:
    """The bf16 layer-gradient pass's operands, in ``csrc/paper_tc.cuh``'s
    kB* order, each (in, out) for dX = dY W: fc_rgb (K 3 -> 16),
    layers_dir.2, .1, [layers_dir.0 feat rows; fc_alpha] (K 129 -> 144),
    fc_feat, layers_xyz.7 .. .1 (layer 4: its h rows); K pads hold ``pad``."""
    def w(name):
        return layers[name][0]

    head = torch.cat([w("layers_dir.0"), w("fc_alpha")], dim=1)
    mats = [("fc_rgb", torch.nn.functional.pad(w("fc_rgb"), (0, 13), value=pad)),
            ("layers_dir.2", w("layers_dir.2")), ("layers_dir.1", w("layers_dir.1")),
            ("head", torch.nn.functional.pad(head, (0, 15), value=pad)),
            ("fc_feat", w("fc_feat"))]
    return mats + [(f"layers_xyz.{i}", w(f"layers_xyz.{i}")[dim:] if i == 4
                    else w(f"layers_xyz.{i}")) for i in range(7, 0, -1)]


def _f32_backward_matrices(layers, dim: int, pad) -> List[Tuple[str, torch.Tensor]]:
    """The f32 backward's weights (``csrc/paper_train.cu`` kT*): nn.Linear
    (out, in) matrices; [layers_dir.0 feat cols; fc_alpha] lie as one (129,
    256) block, layers_xyz.4 gives its h columns only."""
    return [(name, (layers[name][0][dim:] if name == "layers_xyz.4" else layers[name][0]).t())
            for name in ("fc_rgb", "layers_dir.2", "layers_dir.1", "layers_dir.0", "fc_alpha",
                         "fc_feat", "layers_xyz.7", "layers_xyz.6", "layers_xyz.5",
                         "layers_xyz.4", "layers_xyz.3", "layers_xyz.2", "layers_xyz.1")]


class Images(NamedTuple):
    """The family's weight images at one encoding depth, each from
    ``pack_params``' buffer: ``image.pack(params)`` builds one with one
    gather, ``image.unpack(buf)`` gives its operands back."""

    # csrc/paper_tc.cuh FwdLayout, mma.sync fragments of 8-warp blocks: #9's
    # bf16 forward's weights.
    tc_forward: WeightImage
    # csrc/paper_wg.cuh: #4's bf16 weights, each wide layer (out, in) as the
    # swizzled images of its 64-column K slices in the order the kernel's
    # ring streams them (the skip's encoding rows and h rows each a whole
    # number of slices; "layers_xyz.4.enc" and ".h").
    wg_forward: WeightImage
    # csrc/paper_tc.cuh kB*: the bf16 layer-gradient pass's weights.
    tc_backward: WeightImage
    # csrc/paper_train.cu kT*: the f32 backward's weights.
    f32_backward: WeightImage


@functools.lru_cache(maxsize=None)
def images(num_freq: int) -> Images:
    """The family's weight images at encoding depth ``num_freq``."""
    unpack = functools.partial(unpack_params, num_freq=num_freq)
    n, dim = num_params(num_freq), 3 + 6 * num_freq

    def image(matrices, fmt, bf16=True):
        return WeightImage(unpack, n, lambda layers, pad: matrices(layers, dim, pad), fmt, bf16)

    return Images(tc_forward=image(_tc_forward_matrices, Fragments(8)),
                  wg_forward=image(_wg_matrices, Swizzled()),
                  tc_backward=image(_tc_backward_matrices, Fragments(8)),
                  f32_backward=image(_f32_backward_matrices, Rows(), bf16=False))


def paper_plain_forward(pts: torch.Tensor, dc: torch.Tensor, params: torch.Tensor,
                        num_freq: int, compute_dtype: str = "float32", residuals: bool = True):
    """The kernels' forward in plain PyTorch: ``(raw (N, S, 4) f32,
    residuals)``, residuals = (enc, h0..h7, feat, d0, d1, d2), each (N*S, C)
    f32 holding values of the compute dtype (None with ``residuals=False``,
    which frees each trunk activation once the next exists). Differentiable
    in ``params`` and ``dc``."""
    r = rounder(compute_dtype)
    layers = unpack_params(params.float(), num_freq)
    n, s = pts.shape[0], pts.shape[1]

    def dense(name, x):
        w, b = layers[name]
        return torch.addmm(b, x, r(w))

    enc = r(positional_encoding(pts.reshape(-1, 3).float(), num_freq))
    h, hs = enc, []
    for i in range(8):
        # layers_xyz.4 reads [enc, h3], the encoding first.
        h = r(torch.relu(dense(f"layers_xyz.{i}", torch.cat([enc, h], -1) if i == 4 else h)))
        if residuals:
            hs.append(h)
    feat = r(dense("fc_feat", h))                       # no ReLU
    sigma = dense("fc_alpha", feat)                     # from feat
    d = r(torch.relu(dense("layers_dir.0", feat) + dc.float().repeat_interleave(s, dim=0)))
    ds = [d]
    for i in (1, 2):                                    # layers_dir.3 is never run
        d = r(torch.relu(dense(f"layers_dir.{i}", d)))
        ds.append(d)
    rgb = dense("fc_rgb", d)
    out = torch.cat([rgb, sigma], dim=-1).reshape(n, s, 4)
    return out, (enc, *hs, feat, *ds) if residuals else None


def paper_t_plain(model: PaperNeRFModel, pts: torch.Tensor, viewdirs: torch.Tensor,
                  compute_dtype: str = "float32") -> torch.Tensor:
    """Plain PyTorch version of the kernel, same semantics: (N, S, 4) f32."""
    return paper_plain_forward(pts, dir_contribution(model, viewdirs), pack_params(model),
                               model.num_encoding_fn_xyz, compute_dtype, residuals=False)[0]


@functools.lru_cache(maxsize=None)
def _kernel():
    from ._build import load_library

    lib = load_library()
    fn = lib.nerf_paper_t_forward
    ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
    fn.argtypes = [ptr, ptr, ptr, i64, ptr, i64, ptr, i64, i32, i32, i32, ptr]
    fn.restype = ctypes.c_int
    for name in ("nerf_paper_num_params", "nerf_paper_wg_weights"):
        getattr(lib, name).argtypes = [i32]
        getattr(lib, name).restype = i32
    for f in (0, 6, 10, 16):
        got = (lib.nerf_paper_num_params(f), lib.nerf_paper_wg_weights(f))
        want = (num_params(f), images(f).wg_forward.size)
        if got != want:
            raise RuntimeError(f"csrc/paper_mlp.cuh / paper_wg.cuh layouts at {f} frequencies "
                               f"{got} != wrapper's {want}")
    return fn


def fused_paper_mlp_t(model: PaperNeRFModel, pts: torch.Tensor, viewdirs: torch.Tensor,
                      compute_dtype: str = "float32") -> torch.Tensor:
    """Radiance field of ``model`` at ``pts`` (N, S, 3) seen along ``viewdirs``
    (N, 3): (N, S, 4) raw [r, g, b, sigma] f32.

    CPU tensors go through ``paper_t_plain``. CUDA tensors go through the
    kernel; anything it does not take raises. ``fused_paper_mlp_t.launches``
    counts the kernel's launches, ``fused_paper_mlp_t.wgmma_launches`` those
    of its bf16 instance (``csrc/paper_wg.cuh``).
    """
    what = "fused_paper_mlp_t"
    if check_forward(what, supports_fused_paper(model), "a PaperNeRF shape the kernel takes",
                     compute_dtype, model, pts, viewdirs):
        return paper_t_plain(model, pts, viewdirs, compute_dtype)
    n, s = pts.shape[0], pts.shape[1]
    out = torch.empty((n, s, 4), dtype=torch.float32, device=pts.device)
    if n * s == 0:
        return out
    # dc, params and wbf are freed when this returns, before the kernel may
    # have run: the caching allocator hands their blocks out again only in
    # this stream's order, after the kernel.
    with torch.no_grad(), torch.cuda.device(pts.device):
        pts_c = pts.contiguous()
        dc = aligned(dir_contribution(model, viewdirs))
        params = aligned(pack_params(model))
        f = model.num_encoding_fn_xyz
        wbf = images(f).wg_forward.pack(params) if compute_dtype == "bfloat16" else None
        check_rc(what, _kernel()(
            pts_c.data_ptr(), dc.data_ptr(), params.data_ptr(), params.numel(),
            None if wbf is None else wbf.data_ptr(), 0 if wbf is None else wbf.numel(),
            out.data_ptr(), n * s, s, f, int(wbf is not None), cuda_stream(pts.device)))
    fused_paper_mlp_t.launches += 1
    fused_paper_mlp_t.wgmma_launches += wbf is not None
    return out


fused_paper_mlp_t.launches = 0
fused_paper_mlp_t.wgmma_launches = 0

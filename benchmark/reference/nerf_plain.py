"""Plain NeRF: hierarchical volume rendering, the training loss and Adam,
written from the published equations (Mildenhall et al. 2020,
arXiv:2003.08934, and the reference code krrish94/nerf-pytorch that the
configurations follow), over the plain field of the configuration's model
type (``fields/<type>.py``, which shares the layers and encodings here).

Everything is plain PyTorch on whatever device the tensors are on, in
float32 with TF32 off. ``precision`` says what the operands of a layer's
products are rounded to first, its forward's and its gradients': nothing in
``"float32"``; bf16 in ``"bfloat16"``, as a configuration that states bf16
products asks; float8 with a per-tensor scale in ``"fp8"`` (e4m3 forward,
e5m2 gradients), the step below bf16 and the control. Sums, biases,
encodings, compositing and resampling stay float32.

Weights are a dict from the reference's parameter names (``layer1.weight``,
``layers_xyz.0.bias``, ...) to tensors, ``weight`` shaped (out, in).
Random numbers are drawn from a ``torch.Generator`` in the order and shapes
that the trained system draws them, so that both see the same rays and the
same samples: the ray draw, the stratified jitter, the coarse sigma noise,
the resampling uniforms and the fine sigma noise.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, List, NamedTuple, Optional

import torch

PRECISIONS = ("float32", "bfloat16", "fp8")
Weights = Dict[str, torch.Tensor]
# A model type's plain field (``fields/<type>.py``): ``field(model, weights,
# pts (N, S, 3), viewdirs (N, 3), precision)`` -> raw [r, g, b, sigma] (N, S, 4).
Field = Callable[[Dict, Weights, torch.Tensor, torch.Tensor, str], torch.Tensor]


@contextlib.contextmanager
def exact_float32():
    """TF32 off for matrix products and convolutions, restored on exit."""
    cuda_mm = torch.backends.cuda.matmul.allow_tf32
    cudnn = torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = cuda_mm
        torch.backends.cudnn.allow_tf32 = cudnn


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def round_fp8(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` through ``dtype`` (a float8 type) with a per-tensor scale that
    maps its largest magnitude to the type's largest, back in float32."""
    amax = x.detach().abs().max()
    if not torch.isfinite(amax) or amax == 0:
        return x
    scale = amax / torch.finfo(dtype).max
    return (x / scale).to(dtype).to(torch.float32) * scale


ROUNDING = {
    # precision: (rounding of a product's inputs and weights, of a gradient)
    "bfloat16": (round_bf16, round_bf16),
    "fp8": (lambda t: round_fp8(t, torch.float8_e4m3fn),
            lambda t: round_fp8(t, torch.float8_e5m2)),
}


class _RoundedProduct(torch.autograd.Function):
    """``x @ w.T`` on rounded operands, float32 sums; the gradients' products
    on rounded operands too (the bias gradient sums the unrounded one)."""

    @staticmethod
    def forward(ctx, x, w, precision):
        rf = ROUNDING[precision][0]
        xq, wq = rf(x), rf(w)
        ctx.save_for_backward(xq, wq)
        ctx.precision = precision
        return xq @ wq.T

    @staticmethod
    def backward(ctx, g):
        xq, wq = ctx.saved_tensors
        gq = ROUNDING[ctx.precision][1](g)
        dx = gq @ wq
        dw = gq.reshape(-1, gq.shape[-1]).T @ xq.reshape(-1, xq.shape[-1])
        return dx, dw, None


def dense(x: torch.Tensor, weights: Weights, name: str, precision: str) -> torch.Tensor:
    w, b = weights[f"{name}.weight"], weights[f"{name}.bias"]
    if precision in ROUNDING:
        return _RoundedProduct.apply(x, w, precision) + b
    return x @ w.T + b


def encode(x: torch.Tensor, num_fn: int, include_input: bool = True) -> torch.Tensor:
    """``[x, sin(2^0 x), cos(2^0 x), ..., sin(2^(L-1) x), cos(2^(L-1) x)]``."""
    parts = [x] if include_input else []
    for k in range(num_fn):
        f = 2.0 ** k
        parts += [torch.sin(x * f), torch.cos(x * f)]
    return torch.cat(parts, dim=-1)


def encode_inputs(model: Dict, pts: torch.Tensor, viewdirs: torch.Tensor):
    """The sinusoidal encodings of points (N, S, 3) and of unit directions
    (N, 3), the latter broadcast over the samples, as ``model`` (a
    configuration's ``models.coarse`` entry) states them."""
    xyz = encode(pts, int(model["num_encoding_fn_xyz"]), model.get("include_input_xyz", True))
    enc_dir = encode(viewdirs, int(model["num_encoding_fn_dir"]),
                     model.get("include_input_dir", True))
    enc_dir = enc_dir[:, None, :].expand(pts.shape[0], pts.shape[1], enc_dir.shape[-1])
    return xyz, enc_dir


class Composite(NamedTuple):
    rgb: torch.Tensor       # (N, 3)
    weights: torch.Tensor   # (N, S)


def composite(raw: torch.Tensor, z: torch.Tensor, rd: torch.Tensor, white: bool,
              noise: Optional[torch.Tensor], noise_std: float) -> Composite:
    """Alpha compositing along each ray, the last interval 1e10 long."""
    dists = torch.cat([z[:, 1:] - z[:, :-1], torch.full_like(z[:, :1], 1e10)], dim=-1)
    dists = dists * torch.linalg.norm(rd, dim=-1)[:, None]
    sigma = raw[..., 3]
    if noise is not None:
        sigma = sigma + noise * noise_std
    alpha = 1.0 - torch.exp(-torch.relu(sigma) * dists)
    keep = 1.0 - alpha + 1e-10
    trans = torch.cumprod(torch.cat([torch.ones_like(keep[:, :1]), keep[:, :-1]], dim=-1), dim=-1)
    w = alpha * trans
    rgb = torch.sum(w[..., None] * torch.sigmoid(raw[..., :3]), dim=-2)
    if white:
        rgb = rgb + (1.0 - w.sum(dim=-1))[:, None]
    return Composite(rgb, w)


def inverse_cdf(bins: torch.Tensor, weights: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """Depths at the uniforms ``u`` (N, K) of the piecewise-constant pdf of
    ``weights`` (N, M-1) over ``bins`` (N, M): a 1e-5 floor on the weights,
    right-sided search, and a unit denominator under 1e-5."""
    w = weights + 1e-5
    cdf = torch.cumsum(w / w.sum(dim=-1, keepdim=True), dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[:, :1]), cdf], dim=-1)
    idx = torch.searchsorted(cdf.contiguous(), u.contiguous(), right=True)
    below = torch.clamp(idx - 1, min=0)
    above = torch.clamp(idx, max=cdf.shape[-1] - 1)
    c0, c1 = torch.gather(cdf, 1, below), torch.gather(cdf, 1, above)
    b0, b1 = torch.gather(bins, 1, below), torch.gather(bins, 1, above)
    denom = c1 - c0
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    return b0 + (u - c0) / denom * (b1 - b0)


class Rendered(NamedTuple):
    coarse: torch.Tensor    # (N, 3)
    fine: torch.Tensor      # (N, 3)


def render_rays(field: Field, model: Dict, coarse_w: Weights, fine_w: Weights,
                ro: torch.Tensor, rd: torch.Tensor, protocol: Dict,
                generator: Optional[torch.Generator], precision: str) -> Rendered:
    """Coarse then fine rendering of rays (N, 3) through ``field``.
    ``protocol``: a configuration's ``nerf.train`` or ``nerf.validation``
    section with the dataset's ``near`` and ``far``. Random numbers come from
    ``generator`` when ``perturb`` is on."""
    n, nc, nf = ro.shape[0], int(protocol["num_coarse"]), int(protocol["num_fine"])
    perturb = bool(protocol["perturb"])
    std = float(protocol["radiance_field_noise_std"])
    white = bool(protocol["white_background"])
    dev = ro.device

    def rand(k):
        return torch.rand((n, k), generator=generator, device=dev)

    def randn(k):
        return torch.randn((n, k), generator=generator, device=dev) if std > 0 else None

    viewdirs = rd / torch.linalg.norm(rd, dim=-1, keepdim=True)
    t = torch.linspace(0.0, 1.0, nc, device=dev)
    near = torch.full((n, 1), float(protocol["near"]), device=dev)
    far = torch.full((n, 1), float(protocol["far"]), device=dev)
    z = near * (1.0 - t) + far * t
    if perturb:
        mids = 0.5 * (z[:, 1:] + z[:, :-1])
        upper = torch.cat([mids, z[:, -1:]], dim=-1)
        lower = torch.cat([z[:, :1], mids], dim=-1)
        z = lower + (upper - lower) * rand(nc)
    pts = ro[:, None, :] + rd[:, None, :] * z[..., None]
    coarse = composite(field(model, coarse_w, pts, viewdirs, precision), z, rd, white,
                       randn(nc), std)
    u = rand(nf) if perturb else torch.linspace(0.0, 1.0, nf, device=dev).expand(n, nf)
    z_new = inverse_cdf(0.5 * (z[:, 1:] + z[:, :-1]), coarse.weights[:, 1:-1], u).detach()
    z_all, _ = torch.sort(torch.cat([z, z_new], dim=-1), dim=-1)
    pts = ro[:, None, :] + rd[:, None, :] * z_all[..., None]
    fine = composite(field(model, fine_w, pts, viewdirs, precision), z_all, rd, white,
                     randn(nc + nf), std)
    return Rendered(coarse.rgb, fine.rgb)


def step_seed(base_seed: int, step: int) -> int:
    """The seed of training step ``step``'s generator: the trained system
    folds the step into its base seed this way."""
    return (int(base_seed) * 1_000_003 + int(step)) % (2**63 - 1)


class TrainTrace(NamedTuple):
    losses: List[float]              # each step's loss
    first_grad: Dict[str, torch.Tensor]   # step 1's gradient, by leaf
    params: Dict[str, torch.Tensor]       # the leaves after the last step


def train_steps(field: Field, config: Dict, init: Dict[str, torch.Tensor], store,
                base_seed: int, steps: int, precision: str) -> TrainTrace:
    """``steps`` training steps from ``init`` (leaves named ``coarse.<name>``
    and ``fine.<name>``): each draws its batch of rays with replacement from
    ``store`` (origins, directions, colours (R, 3)), renders it, takes
    MSE(coarse) + MSE(fine), its gradient, and an Adam update at the
    exponentially decayed learning rate."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    model = config["models"]["coarse"]
    protocol = dict(config["nerf"]["train"], near=config["dataset"]["near"],
                    far=config["dataset"]["far"])
    opt, sched = config["optimizer"], config["scheduler"]
    lr0 = float(opt["lr"])
    transition = int(float(sched["lr_decay"]) * 1000)
    b1, b2, eps = 0.9, 0.999, 1e-8
    batch = int(protocol["num_random_rays"])
    ro_all, rd_all, rgb_all = store
    dev = ro_all.device
    leaves = {k: v.detach().clone().requires_grad_(True) for k, v in init.items()}
    m = {k: torch.zeros_like(v) for k, v in leaves.items()}
    v2 = {k: torch.zeros_like(v) for k, v in leaves.items()}
    losses, first = [], {}
    with exact_float32():
        for step in range(steps):
            gen = torch.Generator(device=dev).manual_seed(step_seed(base_seed, step))
            idx = torch.randint(ro_all.shape[0], (batch,), generator=gen, device=dev)
            coarse_w = {k[len("coarse."):]: t for k, t in leaves.items() if k.startswith("coarse.")}
            fine_w = {k[len("fine."):]: t for k, t in leaves.items() if k.startswith("fine.")}
            out = render_rays(field, model, coarse_w, fine_w, ro_all[idx], rd_all[idx],
                              protocol, gen, precision)
            target = rgb_all[idx]
            loss = torch.mean((out.coarse - target) ** 2) + torch.mean((out.fine - target) ** 2)
            names = list(leaves)
            got = torch.autograd.grad(loss, [leaves[k] for k in names], allow_unused=True)
            # A leaf the forward never runs (PaperNeRF's layers_dir.3) has none.
            grads = {k: torch.zeros_like(leaves[k]) if g is None else g
                     for k, g in zip(names, got)}
            losses.append(float(loss.detach()))
            if step == 0:
                first = {k: g.detach().clone() for k, g in grads.items()}
            lr = lr0 * float(sched["lr_decay_factor"]) ** (step / transition) if transition > 0 \
                else lr0
            t = step + 1
            with torch.no_grad():
                for k, p in leaves.items():
                    g = grads[k]
                    m[k].mul_(b1).add_(g, alpha=1 - b1)
                    v2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                    denom = (v2[k].sqrt() / math.sqrt(1 - b2 ** t)).add_(eps)
                    p.addcdiv_(m[k], denom, value=-lr / (1 - b1 ** t))
    return TrainTrace(losses, first, {k: v.detach() for k, v in leaves.items()})


def pose_rays(pose: torch.Tensor, height: int, width: int, focal: float):
    """One ray a pixel, row-major, of a (3, 4) camera-to-world ``pose``: the
    pinhole camera looking down -z, y up."""
    dev = pose.device
    j, i = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                          torch.arange(width, device=dev, dtype=torch.float32), indexing="ij")
    dirs = torch.stack([(i - width * 0.5) / focal, -(j - height * 0.5) / focal,
                        -torch.ones_like(i)], dim=-1).reshape(-1, 3)
    rd = torch.sum(dirs[:, None, :] * pose[:3, :3], dim=-1)
    ro = pose[:3, 3].expand(rd.shape)
    return ro, rd


def render_frame(field: Field, config: Dict, coarse_w: Weights, fine_w: Weights,
                 pose: torch.Tensor, height: int, width: int, focal: float, precision: str,
                 chunk: int = 16384) -> torch.Tensor:
    """The (H, W, 3) uint8 frame of ``pose`` at the validation protocol:
    the fine colour clipped to [0, 1], times 255, truncated."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}")
    model = config["models"]["coarse"]
    protocol = dict(config["nerf"]["validation"], near=config["dataset"]["near"],
                    far=config["dataset"]["far"])
    ro, rd = pose_rays(pose, height, width, focal)
    out = []
    with exact_float32(), torch.no_grad():
        for s in range(0, ro.shape[0], chunk):
            rgb = render_rays(field, model, coarse_w, fine_w, ro[s:s + chunk], rd[s:s + chunk],
                              protocol, None, precision).fine
            out.append((torch.clamp(rgb, 0.0, 1.0) * 255.0).to(torch.uint8))
    return torch.cat(out).reshape(height, width, 3)

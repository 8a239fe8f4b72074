"""The plain field of ``HashGridNeRFModel``: Instant-NGP's multiresolution
hash encoding and its two bias-free MLPs (Mueller, Evans, Schied and
Keller, SIGGRAPH 2022, arXiv:2201.05989, Sections 3-4 and 5.4), from the
published equations, all levels at once.

- A point x maps to u = clamp((x + box) / (2 box), 0, 1). Level l has
  resolution N_l = floor(N_min b^l), b = (N_max / N_min)^(1 / (L - 1)); at
  p = u N_l the cell's lower corner is floor(p), held to N_l - 1 on the
  upper face, and its 8 corners weigh trilinearly.
- A level of (N_l + 1)^3 <= T corners indexes them densely, x + (N_l + 1)(y +
  (N_l + 1) z); the others hash them, (x * 1 xor y * 2654435761 xor z *
  805459861) mod T in 32 bits. The levels' rows follow each other in one
  table (``table``, rows x F).
- Density: the L F features -> hidden (ReLU) -> the density outputs h;
  colour: [h, SH(d)] -> hidden (ReLU) -> hidden (ReLU) -> 3 logits, SH the
  real spherical harmonics of degrees 0-3 of the view direction with
  tiny-cuda-nn's signs. Raw sigma is exp(h_0) (its gradient exp(min(h_0,
  15)), the paper's truncated exponential), 0 outside the cube.

Departure noted: the upper face's lower corner (held to N_l - 1, weight 0
on the corners past it) is this repository's convention; the paper leaves it
open.
"""

import math
from typing import Dict, List, Tuple

import torch

from ..nerf_plain import ROUNDING, Weights, _RoundedProduct

PRIMES = (1, 2654435761, 805459861)
EXP_GRAD_CAP = 15.0


def grid_levels(model: Dict) -> List[Tuple[int, int, bool]]:
    """Each level's resolution, rows and whether it is dense, for ``model``
    (a configuration's ``models.coarse`` entry)."""
    n_levels = int(model["num_levels"])
    n_min, n_max = float(model["base_resolution"]), float(model["max_resolution"])
    cap = 2 ** int(model["log2_hashmap_size"])
    out = []
    for level in range(n_levels):
        scale = 2.0 ** (level * math.log2(n_max / n_min) / max(n_levels - 1, 1))
        res = int(math.floor(n_min * scale + 1e-9))
        dense = (res + 1) ** 3 <= cap
        out.append((res, (res + 1) ** 3 if dense else cap, dense))
    return out


def _sh16(d: torch.Tensor) -> torch.Tensor:
    """The 16 real spherical harmonics of degrees 0-3 of unit vectors (P, 3),
    from their closed forms."""
    x, y, z = d.unbind(-1)
    pi = math.pi
    a0 = 0.5 * math.sqrt(1 / pi)
    a1 = math.sqrt(3 / (4 * pi))
    b1, b2, b3 = 0.5 * math.sqrt(15 / pi), 0.25 * math.sqrt(5 / pi), 0.25 * math.sqrt(15 / pi)
    c1, c2 = 0.25 * math.sqrt(35 / (2 * pi)), 0.5 * math.sqrt(105 / pi)
    c3, c4 = 0.25 * math.sqrt(21 / (2 * pi)), 0.25 * math.sqrt(7 / pi)
    c5 = 0.25 * math.sqrt(105 / pi)
    return torch.stack([
        torch.full_like(x, a0),
        -a1 * y, a1 * z, -a1 * x,
        b1 * x * y, -b1 * y * z, b2 * (3 * z * z - 1), -b1 * x * z, b3 * (x * x - y * y),
        -c1 * y * (3 * x * x - y * y), c2 * x * y * z, -c3 * y * (5 * z * z - 1),
        c4 * z * (5 * z * z - 3), -c3 * x * (5 * z * z - 1), c5 * z * (x * x - y * y),
        -c1 * x * (x * x - 3 * y * y),
    ], dim=-1)


def encode(model: Dict, table: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """The hash encoding of points (P, 3): (P, L F)."""
    box = float(model["box"])
    levels = grid_levels(model)
    dev = pts.device
    res = torch.tensor([r for r, _, _ in levels], device=dev, dtype=torch.float32)
    rows = torch.tensor([n for _, n, _ in levels], device=dev, dtype=torch.int64)
    first = torch.cumsum(rows, 0) - rows
    dense = torch.tensor([d for _, _, d in levels], device=dev)
    u = torch.clamp((pts + box) / (2 * box), 0.0, 1.0)
    p = u[:, None, :] * res[None, :, None]                            # (P, L, 3)
    lower = torch.minimum(torch.floor(p), (res - 1)[None, :, None])
    frac = p - lower
    bits = torch.tensor([[c & 1, (c >> 1) & 1, c >> 2] for c in range(8)], device=dev)
    c = lower.to(torch.int64)[:, :, None, :] + bits                   # (P, L, 8, 3)
    w = torch.where(bits.bool(), frac[:, :, None, :], 1 - frac[:, :, None, :]).prod(-1)
    side = (res.to(torch.int64) + 1)[None, :, None]
    dense_row = c[..., 0] + side * (c[..., 1] + side * c[..., 2])
    hashed_row = ((c[..., 0] * PRIMES[0]) ^ (c[..., 1] * PRIMES[1]) ^ (c[..., 2] * PRIMES[2])
                  ) % 2 ** 32 % rows[None, :, None]
    row = torch.where(dense[None, :, None], dense_row, hashed_row) + first[None, :, None]
    feats = (w[..., None] * table[row]).sum(dim=2)                    # (P, L, F)
    return feats.reshape(pts.shape[0], -1)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=EXP_GRAD_CAP))


def field(model: Dict, weights: Weights, pts: torch.Tensor, viewdirs: torch.Tensor,
          precision: str) -> torch.Tensor:
    """Raw [r, g, b, sigma] (N, S, 4) of the field ``model`` at points (N, S,
    3) seen along unit directions (N, 3); each product's operands rounded as
    ``precision`` states, float32 sums."""
    n, s = pts.shape[0], pts.shape[1]
    flat = pts.reshape(-1, 3)

    def product(x, name):
        w = weights[f"{name}.weight"]
        return _RoundedProduct.apply(x, w, precision) if precision in ROUNDING else x @ w.T

    feats = encode(model, weights["table"], flat)
    h = product(torch.relu(product(feats, "density_net.0")), "density_net.1")
    sh = _sh16(viewdirs)[:, None, :].expand(n, s, 16).reshape(n * s, 16)
    y = torch.relu(product(torch.cat([h, sh], dim=-1), "color_net.0"))
    y = torch.relu(product(y, "color_net.1"))
    rgb = product(y, "color_net.2")
    inside = (flat.abs() <= float(model["box"])).all(dim=-1, keepdim=True).to(flat.dtype)
    sigma = _TruncExp.apply(h[:, :1]) * inside
    return torch.cat([rgb, sigma], dim=-1).reshape(n, s, 4)

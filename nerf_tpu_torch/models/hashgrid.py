"""Instant-NGP's radiance field: a multiresolution hash encoding and two small
MLPs without biases (Müller, Evans, Schied and Keller, "Instant Neural
Graphics Primitives with a Multiresolution Hash Encoding", SIGGRAPH 2022,
arXiv:2201.05989, Sections 3-4 and 5.4, as the paper applies it to NeRF).

The JAX package has no such field; it is the port's own.

- Encoding (``ops/encoding.py``): L levels of F features an entry, all in
  one float32 table ``table`` (entries, F), each level's rows at its offset;
  a point x maps to u = (x + box) / (2 box), the cube [-box, box]^3 onto
  [0, 1]^3.
- Density MLP ``density_net``: L * F features -> hidden (ReLU) -> the
  density outputs h; h_0 is log-density.
- Colour MLP ``color_net``: [h, SH(d)] -> hidden (ReLU) -> hidden (ReLU)
  -> 3 rgb logits; SH(d) the degree-4 spherical harmonics of the view
  direction (16 of them).
- Output: raw [r, g, b, sigma] as the renderer takes it, sigma = exp(h_0)
  with the paper's truncated exponential (the gradient exp(min(h_0, 15))),
  and 0 outside the cube, which Instant-NGP never samples. The renderer's
  ReLU on sigma and sigmoid on rgb then give the paper's activations.

The encoding runs in float32; its features go to the products in the compute
dtype with float32 sums, as the other families' plain path does. The module
takes points, not encoded inputs: ``forward(pts, viewdirs, compute_dtype,
encode)``, with ``encode`` the kernel pair (``kernels/hashgrid.py``) or
None for the plain encoding.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..ops.encoding import hash_encode, hash_grid, sh_encode
from ..utils.profiling import FIELD_ENCODE, annotate

# The paper's truncated exponential: the gradient's exponent is held here.
_EXP_CLAMP = 15.0
TABLE_INIT = 1e-4     # entries start U(-1e-4, 1e-4) (the paper's Section 4)


class _TruncExp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.save_for_backward(x)
        return torch.exp(x)

    @staticmethod
    def backward(ctx, g):
        (x,) = ctx.saved_tensors
        return g * torch.exp(torch.clamp(x, max=_EXP_CLAMP))


class HashGridNeRFModel(nn.Module):
    """Instant-NGP's NeRF field at its published shape by default: 16
    levels of 2 features, at most 2^19 entries a level, resolutions 16 to
    2048, 64-wide MLPs, 16 density outputs, SH degree 4, the blender cube of
    half-width 1.5."""

    def __init__(self, num_levels: int = 16, features_per_level: int = 2,
                 log2_hashmap_size: int = 19, base_resolution: int = 16,
                 max_resolution: int = 2048, hidden_size: int = 64,
                 density_outputs: int = 16, sh_degree: int = 4, box: float = 1.5,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.grid = hash_grid(num_levels, features_per_level, log2_hashmap_size,
                              base_resolution, max_resolution, box)
        self.hidden_size = hidden_size
        self.density_outputs = density_outputs
        self.sh_degree = sh_degree
        device = device or "cpu"

        def linear(i, o):
            return nn.utils.skip_init(nn.Linear, i, o, bias=False, device=device)

        self.table = nn.Parameter(torch.empty(self.grid.num_entries, features_per_level,
                                              device=device))
        self.density_net = nn.ModuleList([
            linear(num_levels * features_per_level, hidden_size),
            linear(hidden_size, density_outputs)])
        self.color_net = nn.ModuleList([
            linear(density_outputs + sh_degree ** 2, hidden_size),
            linear(hidden_size, hidden_size),
            linear(hidden_size, 3)])
        self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        """The table U(-1e-4, 1e-4); each product's weights as ``nn.Linear``
        draws them, U(-1/sqrt(fan_in), 1/sqrt(fan_in))."""
        self.table.uniform_(-TABLE_INIT, TABLE_INIT, generator=generator)
        for layer in [*self.density_net, *self.color_net]:
            bound = layer.in_features ** -0.5
            layer.weight.uniform_(-bound, bound, generator=generator)

    def forward(self, pts: torch.Tensor, viewdirs: torch.Tensor,
                compute_dtype: str = "float32",
                encode: Optional[Callable] = None) -> torch.Tensor:
        """Points (N, S, 3) seen along unit directions (N, 3) -> (N, S, 4) raw
        [r, g, b, sigma] float32. ``encode(table, points (P, 3), grid,
        compute_dtype)`` gives the features (P, L * F) in the compute dtype;
        None takes the plain encoding."""
        if viewdirs is None:
            raise ValueError("HashGridNeRFModel needs view directions")
        dtype = getattr(torch, compute_dtype)
        n, s = pts.shape[0], pts.shape[1]
        flat = pts.reshape(-1, 3)
        with annotate(FIELD_ENCODE):
            if encode is None:
                feats = hash_encode(self.table, flat, self.grid).to(dtype)
            else:
                feats = encode(self.table, flat, self.grid, compute_dtype)

        def dense(layer, x):
            return F.linear(x, layer.weight.to(dtype))

        h = dense(self.density_net[1], torch.relu(dense(self.density_net[0], feats)))
        sh = sh_encode(viewdirs, self.sh_degree).to(dtype)
        sh = sh[:, None, :].expand(n, s, sh.shape[-1]).reshape(n * s, -1)
        c = torch.relu(dense(self.color_net[0], torch.cat([h, sh], dim=-1)))
        c = torch.relu(dense(self.color_net[1], c))
        rgb = dense(self.color_net[2], c).float()
        inside = (flat.abs() <= self.grid.box).all(dim=-1, keepdim=True).to(torch.float32)
        sigma = _TruncExp.apply(h[:, :1].float()) * inside
        return torch.cat([rgb, sigma], dim=-1).reshape(n, s, 4)

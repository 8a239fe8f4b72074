"""Encodings of points and directions.

Sinusoidal positional encoding (port of ``nerf_tpu/ops/encoding.py``):
feature layout is the reference's, which checkpoints depend on,
``[x, sin(f0*x), cos(f0*x), sin(f1*x), cos(f1*x), ...]``, each sin/cos block
spanning the whole channel axis.

Instant-NGP's multiresolution hash encoding and the spherical-harmonic
direction encoding (Müller et al. 2022, arXiv:2201.05989, Sections 3-4), for
``models/hashgrid.py``; the JAX package has neither. ``hash_encode`` is the
plain version of ``kernels/hashgrid.py``'s forward kernel.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch


def encoding_dim(num_channels: int, num_encoding_functions: int, include_input: bool = True) -> int:
    """Output feature dimension of ``positional_encoding``."""
    base = num_channels if include_input else 0
    if num_encoding_functions == 0 and not include_input:
        # positional_encoding passes the input through in this case.
        return num_channels
    return base + 2 * num_channels * num_encoding_functions


def frequency_bands(
    num_encoding_functions: int,
    log_sampling: bool = True,
    dtype: torch.dtype = torch.float32,
    device=None,
) -> torch.Tensor:
    """Frequency multipliers 2^linspace(0, N-1, N) (log) or linspace(1, 2^(N-1), N)."""
    top = max(num_encoding_functions - 1, 0)
    steps = max(num_encoding_functions, 1)
    if log_sampling:
        return 2.0 ** torch.linspace(0.0, top, steps, dtype=dtype, device=device)
    return torch.linspace(1.0, 2.0 ** top, steps, dtype=dtype, device=device)


def positional_encoding(
    tensor: torch.Tensor,
    num_encoding_functions: int = 6,
    include_input: bool = True,
    log_sampling: bool = True,
) -> torch.Tensor:
    """Sin/cos encoding of ``tensor`` along its last axis. With
    ``num_encoding_functions == 0`` the input is returned unchanged."""
    if num_encoding_functions == 0:
        return tensor
    freqs = frequency_bands(num_encoding_functions, log_sampling, tensor.dtype, tensor.device)
    scaled = tensor[..., None, :] * freqs[:, None]                       # (..., F, C)
    interleaved = torch.stack([torch.sin(scaled), torch.cos(scaled)], dim=-2)  # (..., F, 2, C)
    flat = interleaved.reshape(
        *tensor.shape[:-1], 2 * num_encoding_functions * tensor.shape[-1]
    )
    if include_input:
        return torch.cat([tensor, flat], dim=-1)
    return flat


def coarse_to_fine_window(
    num_encoding_functions: int, alpha: float, dtype: torch.dtype = torch.float32, device=None
) -> torch.Tensor:
    """BARF per-frequency window (eq. 14): band k is 0 while alpha < k, 1 once
    alpha >= k + 1, and a cosine ramp in between."""
    k = torch.arange(num_encoding_functions, dtype=dtype, device=device)
    x = torch.clamp(alpha - k, 0.0, 1.0)
    return 0.5 * (1.0 - torch.cos(math.pi * x))


# Instant-NGP's spatial hash: one prime a coordinate, the first 1 so that
# neighbours along x stay near each other in the table.
HASH_PRIMES = (1, 2654435761, 805459861)


class HashGrid(NamedTuple):
    """The levels of a multiresolution hash encoding: each level's
    resolution N_l, its first entry in the one table of all levels, its
    number of entries, and whether it is indexed densely ((N_l + 1)^3 <= T
    entries) or by the hash. ``box``: the half-width of the cube [-box,
    box]^3 that the grid spans."""

    resolutions: Tuple[int, ...]
    offsets: Tuple[int, ...]
    sizes: Tuple[int, ...]
    dense: Tuple[bool, ...]
    features: int
    box: float

    @property
    def num_levels(self) -> int:
        return len(self.resolutions)

    @property
    def num_entries(self) -> int:
        return self.offsets[-1] + self.sizes[-1]


def hash_grid(num_levels: int = 16, features_per_level: int = 2, log2_hashmap_size: int = 19,
              base_resolution: int = 16, max_resolution: int = 2048,
              box: float = 1.5) -> HashGrid:
    """The levels of Instant-NGP's encoding: N_l = floor(N_min b^l) with b =
    (N_max / N_min)^(1 / (L - 1)), so that the last level's resolution is
    N_max (a guard of 1e-9 keeps a resolution the exact power reaches from
    rounding below it); at most T = 2^log2_hashmap_size entries a level."""
    cap = 1 << int(log2_hashmap_size)
    growth = max_resolution / base_resolution
    resolutions, offsets, sizes, dense = [], [], [], []
    offset = 0
    for level in range(num_levels):
        power = level / (num_levels - 1) if num_levels > 1 else 0.0
        n = int(math.floor(base_resolution * growth ** power + 1e-9))
        is_dense = (n + 1) ** 3 <= cap
        size = (n + 1) ** 3 if is_dense else cap
        resolutions.append(n)
        offsets.append(offset)
        sizes.append(size)
        dense.append(is_dense)
        offset += size
    return HashGrid(tuple(resolutions), tuple(offsets), tuple(sizes), tuple(dense),
                    int(features_per_level), float(box))


def hash_corners(pts: torch.Tensor, grid: HashGrid, level: int):
    """Each point's 8 corners at ``level``: their rows in the table (P, 8)
    and trilinear weights (P, 8), corner c = (c & 1, c >> 1 & 1, c >> 2)
    along (x, y, z). A point maps to u = (x + box) * (1 / (2 box)), the
    reciprocal rounded to float32 (PyTorch's CUDA division by a scalar
    multiplies by it, so CPU and card agree), clamped to [0, 1]; p = u N_l;
    the lower corner floor(p), held to N_l - 1 on the upper face (where its
    weight is 0). Every operation is one float32 rounding, in the order
    ``csrc/hashgrid.cu`` takes them."""
    n = grid.resolutions[level]
    u = torch.clamp((pts + grid.box) * (1.0 / (2.0 * grid.box)), 0.0, 1.0)
    p = u * float(n)
    lower = torch.clamp(torch.floor(p), max=float(n - 1))
    t = p - lower
    c0 = lower.to(torch.int64)
    rows, weights = [], []
    for corner in range(8):
        bits = [(corner >> axis) & 1 for axis in range(3)]
        c = [c0[:, axis] + bits[axis] for axis in range(3)]
        w = [t[:, axis] if bits[axis] else 1.0 - t[:, axis] for axis in range(3)]
        if grid.dense[level]:
            idx = c[0] + (n + 1) * (c[1] + (n + 1) * c[2])
        else:
            idx = (c[0] * HASH_PRIMES[0]) ^ (c[1] * HASH_PRIMES[1]) ^ (c[2] * HASH_PRIMES[2])
            idx = idx & (grid.sizes[level] - 1)
        rows.append(idx + grid.offsets[level])
        weights.append(w[0] * w[1] * w[2])
    return torch.stack(rows, dim=1), torch.stack(weights, dim=1)


def hash_encode(table: torch.Tensor, pts: torch.Tensor, grid: HashGrid) -> torch.Tensor:
    """The hash encoding of points (P, 3): (P, L * F) float32, level after
    level, each f_l = sum over the 8 corners of w_c * table[row_c], summed in
    corner order. Differentiable in ``table`` through torch's autograd (the
    gather's backward adds into the rows)."""
    feats = []
    for level in range(grid.num_levels):
        rows, w = hash_corners(pts, grid, level)
        acc = w[:, 0:1] * table[rows[:, 0]]
        for corner in range(1, 8):
            acc = acc + w[:, corner:corner + 1] * table[rows[:, corner]]
        feats.append(acc)
    return torch.cat(feats, dim=-1)


def sh_encode(dirs: torch.Tensor, degree: int = 4) -> torch.Tensor:
    """The real spherical harmonics of unit directions (..., 3) of degrees 0
    to ``degree`` - 1 (1, 4, 9 or 16 of them), as tiny-cuda-nn's
    ``SphericalHarmonics`` computes them (its sign convention included)."""
    if not 1 <= degree <= 4:
        raise ValueError(f"sh_encode: degree must be 1..4, got {degree}")
    x, y, z = dirs[..., 0], dirs[..., 1], dirs[..., 2]
    x2, y2, z2 = x * x, y * y, z * z
    xy, yz, xz = x * y, y * z, x * z
    out = [torch.full_like(x, 0.28209479177387814)]
    if degree > 1:
        out += [-0.48860251190291987 * y, 0.48860251190291987 * z, -0.48860251190291987 * x]
    if degree > 2:
        out += [1.0925484305920792 * xy, -1.0925484305920792 * yz,
                0.94617469575755997 * z2 - 0.31539156525251999, -1.0925484305920792 * xz,
                0.54627421529603959 * x2 - 0.54627421529603959 * y2]
    if degree > 3:
        out += [0.59004358992664352 * y * (-3.0 * x2 + y2), 2.8906114426405538 * xy * z,
                0.45704579946446572 * y * (1.0 - 5.0 * z2),
                0.3731763325901154 * z * (5.0 * z2 - 3.0),
                0.45704579946446572 * x * (1.0 - 5.0 * z2),
                1.4453057213202769 * z * (x2 - y2),
                0.59004358992664352 * x * (-x2 + 3.0 * y2)]
    return torch.stack(out, dim=-1)

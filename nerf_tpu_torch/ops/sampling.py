"""Depth sampling along rays (port of ``nerf_tpu/ops/sampling.py``):
stratified coarse samples and hierarchical inverse-CDF resampling.

Random numbers come from an explicit ``torch.Generator`` where the JAX
package threads a key; both functions also take their uniforms from the
caller (``t_rand``, ``u``), so a test can hand both packages the same
numbers and a vmapped caller can hand each scene its own.
"""

from __future__ import annotations

from typing import Optional

import torch


def coarse_z_values(near, far, num_samples: int, lindisp: bool = False,
                    dtype: torch.dtype = torch.float32, device=None) -> torch.Tensor:
    """Uniform depth (or uniform-in-disparity) sample positions.

    near/far: scalars or per-ray (...,) tensors. Returns (..., num_samples).
    """
    if device is None and isinstance(near, torch.Tensor):
        device = near.device
    near = torch.as_tensor(near, dtype=dtype, device=device)[..., None]
    far = torch.as_tensor(far, dtype=dtype, device=device)[..., None]
    t_vals = torch.linspace(0.0, 1.0, num_samples, dtype=dtype, device=device)
    if not lindisp:
        return near * (1.0 - t_vals) + far * t_vals
    return 1.0 / (1.0 / near * (1.0 - t_vals) + 1.0 / far * t_vals)


def perturb_z_values(z_vals: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     t_rand: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Stratified jitter of depth samples within their bins; ``t_rand``
    (shaped like ``z_vals``, in [0, 1)) overrides the uniforms."""
    mids = 0.5 * (z_vals[..., 1:] + z_vals[..., :-1])
    upper = torch.cat([mids, z_vals[..., -1:]], dim=-1)
    lower = torch.cat([z_vals[..., :1], mids], dim=-1)
    if t_rand is None:
        t_rand = torch.rand(z_vals.shape, generator=generator, dtype=z_vals.dtype,
                            device=z_vals.device)
    return lower + (upper - lower) * t_rand


def sample_pdf(
    bins: torch.Tensor,
    weights: torch.Tensor,
    num_samples: int,
    det: bool = False,
    generator: Optional[torch.Generator] = None,
    u: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Hierarchical inverse-transform sampling of ``num_samples`` new depths.

    bins: (..., M) bin edges; weights: (..., M-1) unnormalized bin weights.
    ``u`` (..., num_samples) in [0, 1] overrides the uniforms; otherwise
    ``det`` gives linspace(0, 1) and not ``det`` draws from ``generator``.

    Reference semantics: +1e-5 weight floor, zero-prepended CDF, right-side
    search, [below, above] index clamping and the denom < 1e-5 guard.
    """
    weights = weights + 1e-5
    pdf = weights / torch.sum(weights, dim=-1, keepdim=True)
    cdf = torch.cumsum(pdf, dim=-1)
    cdf = torch.cat([torch.zeros_like(cdf[..., :1]), cdf], dim=-1)      # (..., M)

    shape = cdf.shape[:-1] + (num_samples,)
    if u is None:
        if det:
            u = torch.linspace(0.0, 1.0, num_samples, dtype=cdf.dtype, device=cdf.device)
            u = u.expand(shape)
        else:
            u = torch.rand(shape, generator=generator, dtype=cdf.dtype, device=cdf.device)
    u = u.contiguous()

    m = cdf.shape[-1]
    inds = torch.searchsorted(cdf.contiguous(), u, right=True)          # in [1, M]
    below = torch.clamp(inds - 1, min=0)
    above = torch.clamp(inds, max=m - 1)
    cdf_below = torch.gather(cdf, -1, below)
    cdf_above = torch.gather(cdf, -1, above)
    bins_below = torch.gather(bins, -1, below)
    bins_above = torch.gather(bins, -1, above)

    denom = cdf_above - cdf_below
    denom = torch.where(denom < 1e-5, torch.ones_like(denom), denom)
    t = (u - cdf_below) / denom
    return bins_below + t * (bins_above - bins_below)

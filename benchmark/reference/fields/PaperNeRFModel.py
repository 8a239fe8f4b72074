"""The plain field of ``PaperNeRFModel``, the MLP of Fig. 7 of
arXiv:2003.08934 as the reference code builds it."""

from typing import Dict

import torch

from ..nerf_plain import Weights, dense, encode_inputs


def field(model: Dict, weights: Weights, pts: torch.Tensor, viewdirs: torch.Tensor,
          precision: str) -> torch.Tensor:
    """Raw [r, g, b, sigma] (N, S, 4) of the MLP ``model`` (a configuration's
    ``models.coarse`` entry) at points (N, S, 3) seen along unit directions
    (N, 3)."""
    xyz, enc_dir = encode_inputs(model, pts, viewdirs)
    relu = torch.relu
    h = xyz
    for i in range(8):
        if i == 4:
            h = torch.cat([xyz, h], dim=-1)
        h = relu(dense(h, weights, f"layers_xyz.{i}", precision))
    feat = dense(h, weights, "fc_feat", precision)        # no ReLU (reference)
    alpha = dense(feat, weights, "fc_alpha", precision)   # alpha from feat (reference)
    h = relu(dense(torch.cat([feat, enc_dir], dim=-1), weights, "layers_dir.0", precision))
    for i in (1, 2):                                      # layers_dir.3 is never run
        h = relu(dense(h, weights, f"layers_dir.{i}", precision))
    rgb = dense(h, weights, "fc_rgb", precision)
    return torch.cat([rgb, alpha], dim=-1)

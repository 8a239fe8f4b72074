"""The plain field of ``FlexibleNeRFModel``, krrish94/nerf-pytorch's
configurable MLP, from its published equations."""

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
    n, every = int(model["num_layers"]), int(model.get("skip_connect_every", 4))
    h = dense(xyz, weights, "layer1", precision)          # no ReLU here (reference)
    for i in range(n - 1):
        if i % every == 0 and i > 0 and i != n - 1:
            h = torch.cat([h, xyz], dim=-1)
        h = relu(dense(h, weights, f"layers_xyz.{i}", precision))
    feat = relu(dense(h, weights, "fc_feat", precision))
    alpha = dense(h, weights, "fc_alpha", precision)
    h = relu(dense(torch.cat([feat, enc_dir], dim=-1), weights, "layers_dir.0", precision))
    rgb = dense(h, weights, "fc_rgb", precision)
    return torch.cat([rgb, alpha], dim=-1)

"""A test's plain field of ``ReplicateNeRFModel``, krrish94/nerf-pytorch's
layout of the NeRF supplementary figure: alpha from the trunk, the trunk's
third layer without a ReLU."""

from typing import Dict

import torch

from ..nerf_plain import Weights, dense, encode_inputs


def field(model: Dict, weights: Weights, pts: torch.Tensor, viewdirs: torch.Tensor,
          precision: str) -> torch.Tensor:
    xyz, enc_dir = encode_inputs(model, pts, viewdirs)
    relu = torch.relu
    h = relu(dense(xyz, weights, "layer1", precision))
    h = relu(dense(h, weights, "layer2", precision))
    feat = dense(h, weights, "layer3", precision)
    alpha = dense(h, weights, "fc_alpha", precision)
    y = relu(dense(torch.cat([feat, enc_dir], dim=-1), weights, "layer4", precision))
    y = relu(dense(y, weights, "layer5", precision))
    rgb = dense(y, weights, "fc_rgb", precision)
    return torch.cat([rgb, alpha], dim=-1)

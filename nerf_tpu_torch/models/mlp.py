"""The five radiance-field MLP families as ``nn.Module``s (ports of
``nerf_tpu/models/mlp.py``): ``FlexibleNeRFModel`` and ``PaperNeRFModel``,
which the kernels take, and ``VeryTinyNeRFModel``, ``MultiHeadNeRFModel``
and ``ReplicateNeRFModel``, which run eager only (the JAX package has no
kernel for them either).

Attribute names are the reference's (``layer1``, ``layers_xyz.N``,
``fc_feat``, ``fc_alpha``, ``layers_dir.N``, ``fc_rgb``, ``fc_out``;
``layer1..3``; ``layer3_1``, ``layer3_2``, ``layer4..6``; ``layer1..5``),
so the state dict matches ``nerf_tpu/engine/checkpoint.py:to_torch_state_dict``
key for key and reference ``.ckpt`` files load as they are.

Init is ``nn.Linear``'s: weight and bias ~ U(-1/sqrt(fan_in), 1/sqrt(fan_in)),
drawn from the ``generator`` given (PyTorch's default generator otherwise).

FlexibleNeRF's skip connection is the intended one (concatenate the encoded
xyz back in), under the constructor's condition ``_has_skip`` for both the
shapes and the forward: the reference's forward crashes on it.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn


def _xyz_dir_dims(num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz, include_input_dir):
    dim_xyz = (3 if include_input_xyz else 0) + 2 * 3 * num_encoding_fn_xyz
    dim_dir = (3 if include_input_dir else 0) + 2 * 3 * num_encoding_fn_dir
    return dim_xyz, dim_dir


def _linear(layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """``x @ W.T + b`` in the dtype of ``x`` (the JAX ``linear``: bf16 inputs
    give bf16 outputs)."""
    return F.linear(x, layer.weight.to(x.dtype), layer.bias.to(x.dtype))


class FlexibleNeRFModel(nn.Module):
    """Configurable-depth NeRF MLP; the defaults (4 layers, 128 hidden) are
    the shape of every reference checkpoint."""

    def __init__(
        self,
        num_layers: int = 4,
        hidden_size: int = 128,
        skip_connect_every: int = 4,
        num_encoding_fn_xyz: int = 6,
        num_encoding_fn_dir: int = 4,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
        use_viewdirs: bool = True,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_connect_every = skip_connect_every
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_xyz = include_input_xyz
        self.include_input_dir = include_input_dir
        self.use_viewdirs = use_viewdirs
        self.dim_xyz, dim_dir = _xyz_dir_dims(
            num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz, include_input_dir
        )
        self.dim_dir = dim_dir if use_viewdirs else 0

        h = hidden_size

        def linear(i, o):
            return nn.utils.skip_init(nn.Linear, i, o, device=device or "cpu")

        # Registration order is the reference's parameters() order.
        self.layer1 = linear(self.dim_xyz, h)
        self.layers_xyz = nn.ModuleList(
            linear(self.dim_xyz + h if self._has_skip(i) else h, h)
            for i in range(num_layers - 1)
        )
        if use_viewdirs:
            self.layers_dir = nn.ModuleList([linear(self.dim_dir + h, h // 2)])
            self.fc_alpha = linear(h, 1)
            self.fc_rgb = linear(h // 2, 3)
            self.fc_feat = linear(h, h)
        else:
            self.fc_out = linear(h, 4)
        self.reset_parameters(generator)

    @property
    def input_dim(self) -> int:
        return self.dim_xyz + self.dim_dir

    def _has_skip(self, i: int) -> bool:
        """Skip-connection condition for layers_xyz[i]."""
        return i % self.skip_connect_every == 0 and i > 0 and i != self.num_layers - 1

    @torch.no_grad()
    def reset_parameters(self, generator: Optional[torch.Generator] = None) -> None:
        for layer in self.modules():
            if isinstance(layer, nn.Linear):
                bound = 1.0 / math.sqrt(layer.in_features)
                layer.weight.uniform_(-bound, bound, generator=generator)
                layer.bias.uniform_(-bound, bound, generator=generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., dim_xyz [+ dim_dir]) encoded input -> (..., 4) raw [r, g, b, sigma]."""
        xyz = x[..., : self.dim_xyz]
        h = _linear(self.layer1, xyz)
        for i, layer in enumerate(self.layers_xyz):
            if self._has_skip(i):
                h = torch.cat([h, xyz], dim=-1)
            h = torch.relu(_linear(layer, h))
        if not self.use_viewdirs:
            return _linear(self.fc_out, h)
        feat = torch.relu(_linear(self.fc_feat, h))
        alpha = _linear(self.fc_alpha, h)
        h = torch.cat([feat, x[..., self.dim_xyz:]], dim=-1)
        for layer in self.layers_dir:
            h = torch.relu(_linear(layer, h))
        rgb = _linear(self.fc_rgb, h)
        return torch.cat([rgb, alpha], dim=-1)


class PaperNeRFModel(nn.Module):
    """The NeRF paper's Fig. 7 model (reference models.py:123-183): an 8x256
    trunk with the encoding re-injected at layer 4, a 128-wide direction
    branch.

    The reference's quirks are kept: the 8/256/128 layout is fixed whatever
    ``num_layers``/``hidden_size`` say; layer 4 reads ``[enc_xyz, h]``
    (encoding first); ``fc_feat`` has no ReLU; alpha is read from ``feat``,
    not from the trunk; ``layers_dir[3]`` exists in the state dict but the
    forward never runs it.
    """

    def __init__(
        self,
        num_layers: int = 8,
        hidden_size: int = 256,
        skip_connect_every: int = 4,
        num_encoding_fn_xyz: int = 6,
        num_encoding_fn_dir: int = 4,
        include_input_xyz: bool = True,
        include_input_dir: bool = True,
        use_viewdirs: bool = True,
        generator: Optional[torch.Generator] = None,
        device=None,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.hidden_size = hidden_size
        self.skip_connect_every = skip_connect_every
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_xyz = include_input_xyz
        self.include_input_dir = include_input_dir
        self.use_viewdirs = use_viewdirs
        self.dim_xyz, dim_dir = _xyz_dir_dims(
            num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz, include_input_dir
        )
        self.dim_dir = dim_dir if use_viewdirs else 0

        def linear(i, o):
            return nn.utils.skip_init(nn.Linear, i, o, device=device or "cpu")

        # Registration order is the reference's parameters() order.
        self.layers_xyz = nn.ModuleList(
            linear(self.dim_xyz if i == 0 else self.dim_xyz + 256 if i == 4 else 256, 256)
            for i in range(8)
        )
        self.fc_feat = linear(256, 256)
        self.fc_alpha = linear(256, 1)
        self.layers_dir = nn.ModuleList(
            [linear(256 + self.dim_dir, 128)] + [linear(128, 128) for _ in range(3)]
        )
        self.fc_rgb = linear(128, 3)
        self.reset_parameters(generator)

    @property
    def input_dim(self) -> int:
        return self.dim_xyz + self.dim_dir

    reset_parameters = FlexibleNeRFModel.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., dim_xyz [+ dim_dir]) encoded input -> (..., 4) raw [r, g, b, sigma]."""
        xyz = x[..., : self.dim_xyz]
        h = xyz
        for i, layer in enumerate(self.layers_xyz):
            if i == 4:
                h = torch.cat([xyz, h], dim=-1)
            h = torch.relu(_linear(layer, h))
        feat = _linear(self.fc_feat, h)
        alpha = _linear(self.fc_alpha, feat)
        if self.use_viewdirs:
            feat = torch.cat([feat, x[..., self.dim_xyz:]], dim=-1)
        h = torch.relu(_linear(self.layers_dir[0], feat))
        # layers_dir[3] is never run (reference models.py:178-180).
        for layer in self.layers_dir[1:3]:
            h = torch.relu(_linear(layer, h))
        rgb = _linear(self.fc_rgb, h)
        return torch.cat([rgb, alpha], dim=-1)


def _skip_linear(device):
    def linear(i, o):
        return nn.utils.skip_init(nn.Linear, i, o, device=device or "cpu")

    return linear


class VeryTinyNeRFModel(nn.Module):
    """Three linear layers over the jointly encoded (xyz [, dir]) input
    (reference models.py:4-31). The reference's quirk is kept: the
    direction's width is the xyz encoding's (``dim_dir == dim_xyz``), so a
    config must encode the direction with ``num_encoding_functions`` too."""

    def __init__(self, filter_size: int = 128, num_encoding_functions: int = 6,
                 use_viewdirs: bool = True, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.filter_size = filter_size
        self.num_encoding_functions = num_encoding_functions
        self.use_viewdirs = use_viewdirs
        self.dim_xyz = 3 + 3 * 2 * num_encoding_functions
        self.dim_dir = self.dim_xyz if use_viewdirs else 0
        linear = _skip_linear(device)
        self.layer1 = linear(self.dim_xyz + self.dim_dir, filter_size)
        self.layer2 = linear(filter_size, filter_size)
        self.layer3 = linear(filter_size, 4)
        self.reset_parameters(generator)

    @property
    def input_dim(self) -> int:
        return self.dim_xyz + self.dim_dir

    reset_parameters = FlexibleNeRFModel.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., input_dim) encoded input -> (..., 4) raw [r, g, b, sigma]."""
        x = torch.relu(_linear(self.layer1, x))
        x = torch.relu(_linear(self.layer2, x))
        return _linear(self.layer3, x)


class MultiHeadNeRFModel(nn.Module):
    """A two-layer trunk on the xyz encoding with a sigma head and a feature
    head, the rgb head on ``[feat, dir]`` (reference models.py:34-78); like
    VeryTiny, ``dim_dir == dim_xyz``."""

    def __init__(self, hidden_size: int = 128, num_encoding_functions: int = 6,
                 use_viewdirs: bool = True, generator: Optional[torch.Generator] = None,
                 device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_encoding_functions = num_encoding_functions
        self.use_viewdirs = use_viewdirs
        self.dim_xyz = 3 + 3 * 2 * num_encoding_functions
        self.dim_dir = self.dim_xyz if use_viewdirs else 0
        h = hidden_size
        linear = _skip_linear(device)
        self.layer1 = linear(self.dim_xyz, h)
        self.layer2 = linear(h, h)
        self.layer3_1 = linear(h, 1)
        self.layer3_2 = linear(h, h)
        self.layer4 = linear(self.dim_dir + h, h)
        self.layer5 = linear(h, h)
        self.layer6 = linear(h, 3)
        self.reset_parameters(generator)

    @property
    def input_dim(self) -> int:
        return self.dim_xyz + self.dim_dir

    reset_parameters = FlexibleNeRFModel.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., input_dim) encoded input -> (..., 4) raw [r, g, b, sigma]."""
        xyz, view = x[..., : self.dim_xyz], x[..., self.dim_xyz:]
        h = torch.relu(_linear(self.layer1, xyz))
        h = torch.relu(_linear(self.layer2, h))
        sigma = _linear(self.layer3_1, h)
        feat = torch.relu(_linear(self.layer3_2, h))
        h = torch.relu(_linear(self.layer4, torch.cat([feat, view], dim=-1)))
        h = torch.relu(_linear(self.layer5, h))
        rgb = _linear(self.layer6, h)
        return torch.cat([rgb, sigma], dim=-1)


class ReplicateNeRFModel(nn.Module):
    """The NeRF supplementary figure's layout: a three-layer trunk and a
    two-layer direction branch at half width (reference models.py:81-120).
    Its quirks are kept: ``layer3``'s feature has no ReLU, alpha is read from
    the trunk (not from the feature), and ``num_layers`` is accepted and
    ignored (the layout is fixed)."""

    def __init__(self, hidden_size: int = 256, num_layers: int = 4,
                 num_encoding_fn_xyz: int = 6, num_encoding_fn_dir: int = 4,
                 include_input_xyz: bool = True, include_input_dir: bool = True,
                 generator: Optional[torch.Generator] = None, device=None):
        super().__init__()
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_encoding_fn_xyz = num_encoding_fn_xyz
        self.num_encoding_fn_dir = num_encoding_fn_dir
        self.include_input_xyz = include_input_xyz
        self.include_input_dir = include_input_dir
        self.dim_xyz, self.dim_dir = _xyz_dir_dims(
            num_encoding_fn_xyz, num_encoding_fn_dir, include_input_xyz, include_input_dir
        )
        h = hidden_size
        linear = _skip_linear(device)
        self.layer1 = linear(self.dim_xyz, h)
        self.layer2 = linear(h, h)
        self.layer3 = linear(h, h)
        self.fc_alpha = linear(h, 1)
        self.layer4 = linear(h + self.dim_dir, h // 2)
        self.layer5 = linear(h // 2, h // 2)
        self.fc_rgb = linear(h // 2, 3)
        self.reset_parameters(generator)

    @property
    def input_dim(self) -> int:
        return self.dim_xyz + self.dim_dir

    reset_parameters = FlexibleNeRFModel.reset_parameters

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """(..., input_dim) encoded input -> (..., 4) raw [r, g, b, sigma]."""
        xyz, direction = x[..., : self.dim_xyz], x[..., self.dim_xyz:]
        h = torch.relu(_linear(self.layer1, xyz))
        h = torch.relu(_linear(self.layer2, h))
        feat = _linear(self.layer3, h)
        alpha = _linear(self.fc_alpha, h)
        y = torch.relu(_linear(self.layer4, torch.cat([feat, direction], dim=-1)))
        y = torch.relu(_linear(self.layer5, y))
        rgb = _linear(self.fc_rgb, y)
        return torch.cat([rgb, alpha], dim=-1)

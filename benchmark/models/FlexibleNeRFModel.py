"""The benchmark's plug-in for ``FlexibleNeRFModel``, the configurable MLP of
krrish94/nerf-pytorch (``flex_4x128``): the training pair #8 and the render
forward #1 that its fields run through, its seeding and its counts."""

from typing import Dict, List

from benchmark.drivers.common import seed_linears
from benchmark.harness.counts import Dense, dense_bytes, dense_flops, encoding_width

# The plain versions that stand in for the kernels on the CPU, counted on
# the kernels' counters: (module, plain function, kernel wrapper, counter).
CPU_STANDINS = (
    ("nerf_tpu_torch.kernels.flex_train", "flex_train_plain_fwd", "fused_flex_mlp_train",
     "fwd_launches"),
    ("nerf_tpu_torch.kernels.flex_train", "flex_train_plain_bwd", "fused_flex_mlp_train",
     "bwd_launches"),
    ("nerf_tpu_torch.kernels.mlp_t", "mlp_t_plain", "fused_mlp_t", "launches"),
)


def train_counters() -> Dict:
    """The counters that show a training step's fields ran through #8:
    ``{check: (wrapper, counter, launches a field evaluation)}``."""
    from nerf_tpu_torch.kernels.flex_train import fused_flex_mlp_train

    return {"field_fwd_launches": (fused_flex_mlp_train, "fwd_launches", 1),
            "field_bwd_launches": (fused_flex_mlp_train, "bwd_launches", 1)}


def render_counters() -> Dict:
    """The counter that shows a frame's fields ran through #1."""
    from nerf_tpu_torch.kernels.mlp_t import fused_mlp_t

    return {"field_launches": (fused_mlp_t, "launches", 1)}


def seed(modules, seed: int, device, opacify: bool = False) -> None:
    seed_linears(modules, seed, device, opacify, density_bias="fc_alpha")


def layers(model: Dict) -> List[Dense]:
    """The layers of ``model`` (a configuration's ``models.coarse`` entry)
    in the order the forward runs them."""
    xyz = encoding_width(int(model["num_encoding_fn_xyz"]), model.get("include_input_xyz", True))
    dirs = encoding_width(int(model["num_encoding_fn_dir"]), model.get("include_input_dir", True))
    h = int(model["hidden_size"])
    n = int(model["num_layers"])
    every = int(model.get("skip_connect_every", 4))
    out = [Dense("layer1", xyz, h, 0)]
    for i in range(n - 1):
        skip = i % every == 0 and i > 0 and i != n - 1
        out.append(Dense(f"layers_xyz.{i}", h + (xyz if skip else 0), h, h))
    if not model.get("use_viewdirs", True):
        return out + [Dense("fc_out", h, 4, h)]
    return out + [
        Dense("fc_feat", h, h, h),
        Dense("fc_alpha", h, 1, h),
        Dense("layers_dir.0", h + dirs, h // 2, h),
        Dense("fc_rgb", h // 2, 3, h // 2),
    ]


def flops(model: Dict, points: int, backward: bool) -> float:
    return dense_flops(layers(model), points, backward)


def nbytes(model: Dict, rays: int, points: int, backward: bool) -> float:
    return dense_bytes(layers(model), rays, points, backward)

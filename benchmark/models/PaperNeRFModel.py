"""The benchmark's plug-in for ``PaperNeRFModel``, the 8x256 MLP of Fig. 7 of
arXiv:2003.08934 (``paper_8x256``): the training pair #9 and the render
forward #4 that its fields run through, its seeding and its counts."""

from typing import Dict, List

from benchmark.drivers.common import seed_linears
from benchmark.harness.counts import Dense, dense_bytes, dense_flops, encoding_width

# The plain versions that stand in for the kernels on the CPU, counted on
# the kernels' counters: (module, plain function, kernel wrapper, counter).
CPU_STANDINS = (
    ("nerf_tpu_torch.kernels.paper_train", "paper_train_plain_fwd", "fused_paper_mlp_train",
     "fwd_launches"),
    ("nerf_tpu_torch.kernels.paper_train", "paper_train_plain_bwd", "fused_paper_mlp_train",
     "bwd_launches"),
    ("nerf_tpu_torch.kernels.paper_t", "paper_t_plain", "fused_paper_mlp_t", "launches"),
)


def train_counters() -> Dict:
    """The counters that show a training step's fields ran through #9:
    ``{check: (wrapper, counter, launches a field evaluation)}``."""
    from nerf_tpu_torch.kernels.paper_train import fused_paper_mlp_train

    return {"field_fwd_launches": (fused_paper_mlp_train, "fwd_launches", 1),
            "field_bwd_launches": (fused_paper_mlp_train, "bwd_launches", 1)}


def render_counters() -> Dict:
    """The counter that shows a frame's fields ran through #4."""
    from nerf_tpu_torch.kernels.paper_t import fused_paper_mlp_t

    return {"field_launches": (fused_paper_mlp_t, "launches", 1)}


def seed(modules, seed: int, device, opacify: bool = False) -> None:
    seed_linears(modules, seed, device, opacify, density_bias="fc_alpha")


def layers(model: Dict) -> List[Dense]:
    """The layers of ``model`` (a configuration's ``models.coarse`` entry)
    in the order the forward runs them: Fig. 7 of arXiv:2003.08934 as the
    reference code builds it. The encoding re-enters before the fifth layer,
    alpha is read from fc_feat, and two further 128-wide direction layers
    run (a third is built and never run)."""
    xyz = encoding_width(int(model["num_encoding_fn_xyz"]), model.get("include_input_xyz", True))
    dirs = encoding_width(int(model["num_encoding_fn_dir"]), model.get("include_input_dir", True))
    out = [Dense("layers_xyz.0", xyz, 256, 0)]
    for i in range(1, 8):
        out.append(Dense(f"layers_xyz.{i}", 256 + (xyz if i == 4 else 0), 256, 256))
    return out + [
        Dense("fc_feat", 256, 256, 256),
        Dense("fc_alpha", 256, 1, 256),
        Dense("layers_dir.0", 256 + dirs, 128, 256),
        Dense("layers_dir.1", 128, 128, 128),
        Dense("layers_dir.2", 128, 128, 128),
        Dense("fc_rgb", 128, 3, 128),
    ]


def flops(model: Dict, points: int, backward: bool) -> float:
    return dense_flops(layers(model), points, backward)


def nbytes(model: Dict, rays: int, points: int, backward: bool) -> float:
    return dense_bytes(layers(model), rays, points, backward)

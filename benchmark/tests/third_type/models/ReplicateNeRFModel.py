"""A test's plug-in for ``ReplicateNeRFModel``: no kernel of the port takes
it, so it names no launch counter and no stand-in; its seeding and counts
are the MLPs'."""

from typing import Dict, List

from benchmark.drivers.common import seed_linears
from benchmark.harness.counts import Dense, dense_bytes, dense_flops, encoding_width

CPU_STANDINS = ()


def train_counters() -> Dict:
    return {}


def render_counters() -> Dict:
    return {}


def seed(modules, seed: int, device, opacify: bool = False) -> None:
    seed_linears(modules, seed, device, opacify, density_bias="fc_alpha")


def layers(model: Dict) -> List[Dense]:
    xyz = encoding_width(int(model["num_encoding_fn_xyz"]), model.get("include_input_xyz", True))
    dirs = encoding_width(int(model["num_encoding_fn_dir"]), model.get("include_input_dir", True))
    h = int(model["hidden_size"])
    return [Dense("layer1", xyz, h, 0), Dense("layer2", h, h, h), Dense("layer3", h, h, h),
            Dense("fc_alpha", h, 1, h), Dense("layer4", h + dirs, h // 2, h),
            Dense("layer5", h // 2, h // 2, h // 2), Dense("fc_rgb", h // 2, 3, h // 2)]


def flops(model: Dict, points: int, backward: bool) -> float:
    return dense_flops(layers(model), points, backward)


def nbytes(model: Dict, rays: int, points: int, backward: bool) -> float:
    return dense_bytes(layers(model), rays, points, backward)

"""The benchmark's plug-in for ``HashGridNeRFModel``, Instant-NGP's hash-grid
field (``ngp_hash_l16``): the hash-encoding kernel pair its fields' encodings
run through, its seeding and its counts. The field's operations are its
MLPs' products; its bytes are its encoding's, whose table dominates them."""

import math
from typing import Dict, List

import torch

from benchmark.harness.counts import Dense, dense_flops, forward_macs
from benchmark.reference.fields.HashGridNeRFModel import grid_levels

# The plain versions that stand in for the kernels on the CPU, counted on
# the kernels' counters: (module, plain function, kernel wrapper, counter).
CPU_STANDINS = (
    ("nerf_tpu_torch.kernels.hashgrid", "hash_encode_plain", "fused_hash_encode",
     "fwd_launches"),
    ("nerf_tpu_torch.kernels.hashgrid", "hash_encode_plain_bwd", "fused_hash_encode",
     "bwd_launches"),
)
TABLE_INIT = 1e-4          # table entries U(-1e-4, 1e-4), the paper's Section 4
DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2}


def train_counters() -> Dict:
    """The counters that show a training step's encodings ran through the
    kernel pair: ``{check: (wrapper, counter, launches a field evaluation)}``."""
    from nerf_tpu_torch.kernels.hashgrid import fused_hash_encode

    return {"field_fwd_launches": (fused_hash_encode, "fwd_launches", 1),
            "field_bwd_launches": (fused_hash_encode, "bwd_launches", 1)}


def render_counters() -> Dict:
    """The counter that shows a frame's encodings ran through the forward
    kernel."""
    from nerf_tpu_torch.kernels.hashgrid import fused_hash_encode

    return {"field_launches": (fused_hash_encode, "fwd_launches", 1)}


def seed(modules, seed: int, device, opacify: bool = False) -> None:
    """Each module's table U(-1e-4, 1e-4) and each product's weights
    U(-1/sqrt(fan_in), 1/sqrt(fan_in)) (no biases), from one draw of
    uniforms on ``device``. ``opacify`` changes nothing: with such a table
    every point in the cube has a density near exp(0) = 1, so a frame of a
    seeded field is mostly opaque already."""
    linears = [layer for mod in modules for layer in [*mod.density_net, *mod.color_net]]
    total = sum(mod.table.numel() for mod in modules) + sum(m.weight.numel() for m in linears)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    u = torch.rand(total, generator=gen, device=device).mul_(2.0).sub_(1.0)
    off = 0
    with torch.no_grad():
        for p, bound in [(mod.table, TABLE_INIT) for mod in modules] + [
                (m.weight, 1.0 / math.sqrt(m.in_features)) for m in linears]:
            p.copy_(u[off:off + p.numel()].view_as(p)).mul_(bound)
            off += p.numel()


def layers(model: Dict) -> List[Dense]:
    """The products of a point, in the order the forward runs them: the
    encoded features and the density outputs need a gradient (the table
    learns through them), the view direction's harmonics none."""
    feats = int(model["num_levels"]) * int(model["features_per_level"])
    h, dens = int(model["hidden_size"]), int(model["density_outputs"])
    sh = int(model["sh_degree"]) ** 2
    return [Dense("density_net.0", feats, h, feats), Dense("density_net.1", h, dens, h),
            Dense("color_net.0", dens + sh, h, dens), Dense("color_net.1", h, h, h),
            Dense("color_net.2", h, 3, h)]


def table_rows(model: Dict) -> int:
    """Rows of one field's table: every level's."""
    return sum(rows for _, rows, _ in grid_levels(model))


def flops(model: Dict, points: int, backward: bool) -> float:
    return dense_flops(layers(model), points, backward)


def encode_bytes(model: Dict, points: int, backward: bool, dtype: str = "float32") -> float:
    """Bytes a field's encoding kernels must move at least: the points (3
    f32) in, the features (L F in ``dtype``) out and the table (f32) read
    once; with ``backward``, the points and the features' gradient in again.
    No table-wide write is counted for the backward: its adds reach only the
    rows the points touch, in a gradient zeroed before it by a fill that is
    not one of these kernels."""
    table = 4.0 * table_rows(model) * int(model["features_per_level"])
    width = int(model["num_levels"]) * int(model["features_per_level"])
    stream = points * (12.0 + DTYPE_BYTES[dtype] * width)
    return (2 * stream if backward else stream) + table


def nbytes(model: Dict, rays: int, points: int, backward: bool) -> float:
    """Bytes a field evaluation must move at least, in f32: points (3) and
    view directions (3 a ray), the weights (no biases) and the table in, raw
    rgb + sigma (4) out; with ``backward``, the cotangent (4 a point), the
    points and directions in again, the weights read and their gradients and
    the table's gradient written."""
    weights = forward_macs(layers(model))
    table = table_rows(model) * int(model["features_per_level"])
    nb = 4.0 * (3 * points + 3 * rays + weights + table + 4 * points)
    if backward:
        nb += 4.0 * (4 * points + 3 * points + 3 * rays + 2 * weights + table)
    return nb

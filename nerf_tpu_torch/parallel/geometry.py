"""The density-grid sweep sharded over the ranks of a mesh (port of
``nerf_tpu/parallel/geometry.py``).

The R^3 sigma sweep splits over chunk indices: each rank sweeps a
contiguous block of them with the serial sweep's own body, and rank 0
gathers the blocks (``engine.geometry.make_sigma_grid_fn`` with a mesh).
The chunk boundaries are the serial sweep's, and so is the padded tail that
is sliced off, so the grid is bitwise the serial one's on the same device.
There is no reduction at all; the parameters are every rank's own
replicated copy.
"""

from __future__ import annotations

from typing import Tuple

from ..engine.geometry import make_sigma_grid_fn
from ..engine.renderer import RenderSettings
from .mesh import Mesh


def make_parallel_sigma_grid_fn(model, settings: RenderSettings, resolution: int,
                                bbox_min: Tuple[float, float, float],
                                bbox_max: Tuple[float, float, float], mesh: Mesh,
                                chunk: int = 65536):
    """Build ``grid_fn() -> (R, R, R) float32 sigma`` (numpy) on rank 0, None
    on the other ranks: ``engine.geometry.make_sigma_grid_fn`` with the
    mesh."""
    return make_sigma_grid_fn(model, settings, resolution, bbox_min, bbox_max, chunk, mesh=mesh)

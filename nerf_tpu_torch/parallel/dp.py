"""Data-parallel (ray-parallel) training and rendering over the ranks of a
mesh (port of ``nerf_tpu/parallel/dp.py``).

Rays shard over the ranks; the parameters and the optimizer state are
replicated (every rank starts from the same weights and applies the same
update). The serial engine's factories take the mesh themselves, so one
path serves one rank and many; the functions here keep the JAX package's
names over them:

  - training: ``engine.train.make_train_step`` / ``make_train_loop`` with a
    ``mesh`` render and back-propagate this rank's rays, then one
    ``all_reduce_mean`` averages the gradients and the three losses (the
    JAX ``lax.pmean``) before the non-finite guard, the clipping and the
    optimizer step, so no two ranks can disagree on skipping a step. With
    ``use_pallas_train`` every rank launches the model family's training
    kernels (#8 for the 4x128 FlexibleNeRF, #9 for the 8x256 PaperNeRF).
    On more than one rank, step t's generator is seeded with
    ``fold_seed(fold_seed(base_seed, t), rank)``.
  - rendering: ``engine.renderer.make_image_render_fn`` /
    ``make_pose_render_fn`` with a ``mesh`` render this rank's contiguous
    range of the pixels (the kernel path, #1 for the 4x128 model under
    ``use_pallas``) in ``chunksize`` chunks and assemble the maps on rank 0,
    where the JAX out-spec sharding assembles a global array. The other
    ranks get None.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..engine.renderer import (
    RenderSettings,
    gather_maps,
    make_image_render_fn,
    make_pose_render_fn,
    render_maps_dict,
    render_rays,
)
from ..engine.train import make_train_loop, make_train_step
from .mesh import Mesh, shard_rows


def make_parallel_train_step(model_coarse, model_fine, settings: RenderSettings, mesh: Mesh,
                             nan_guard: bool = False):
    """``step(state, ro (b, 3), rd (b, 3), target (b, 3), generator) ->
    (state, StepMetrics)`` on this rank's ``b = B / world`` rays of the
    global batch (``mesh.shard_rows``): ``engine.train.make_train_step``
    with the mesh. The metrics are the global batch's, the same on every
    rank."""
    return make_train_step(model_coarse, model_fine, settings, nan_guard=nan_guard, mesh=mesh)


def make_parallel_train_loop(model_coarse, model_fine, settings: RenderSettings, mesh: Mesh,
                             batch_size: int, steps_per_call: int, nan_guard: bool = False,
                             sample_mode: str = "gather"):
    """``loop(state, ro_store, rd_store, tgt_store, base_seed) -> (state,
    StepMetrics of (steps_per_call,) device tensors)`` with this rank's
    slice of the ray store and ``batch_size`` the GLOBAL batch:
    ``engine.train.make_train_loop`` with the mesh."""
    return make_train_loop(model_coarse, model_fine, settings, batch_size, steps_per_call,
                           nan_guard=nan_guard, sample_mode=sample_mode, mesh=mesh)


def make_parallel_render_fn(model_coarse, model_fine, settings: RenderSettings, mesh: Mesh):
    """``render(ro (N, 3), rd (N, 3)) -> maps`` on rank 0 (None elsewhere):
    every rank renders its ``N / world`` rows of the (replicated) rays in one
    call with the deterministic settings. N must divide by the world
    (``pad_to_devices``)."""
    eval_settings = settings.eval_variant()

    def render(ro, rd) -> Optional[Dict[str, torch.Tensor]]:
        n = ro.shape[0]
        ro, rd = shard_rows(mesh, ro, rd)
        with torch.inference_mode():
            maps = render_maps_dict(render_rays(model_coarse, model_fine, ro, rd, eval_settings))
        return gather_maps(mesh, maps, n)

    return render


def make_parallel_image_render_fn(model_coarse, model_fine, settings: RenderSettings,
                                  mesh: Mesh) -> Callable:
    """``render_image(ray_origins (H, W, 3), ray_directions (H, W, 3)) ->
    dict`` of (H, W[, 3]) maps on rank 0 (None elsewhere), with the
    deterministic settings: ``engine.renderer.make_image_render_fn`` with
    the mesh."""
    return make_image_render_fn(model_coarse, model_fine, settings.eval_variant(), mesh=mesh)


def make_parallel_pose_render_fn(model_coarse, model_fine, settings: RenderSettings,
                                 height: int, width: int, focal: float, mesh: Mesh,
                                 output: str = "maps") -> Callable:
    """``render(pose34) -> out`` on rank 0 (None elsewhere), with the
    deterministic settings: ``engine.renderer.make_pose_render_fn`` with the
    mesh (only the (3, 4) pose reaches a rank)."""
    return make_pose_render_fn(model_coarse, model_fine, settings.eval_variant(), height, width,
                               focal, output=output, mesh=mesh)

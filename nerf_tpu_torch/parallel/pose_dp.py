"""Data-parallel camera-pose refinement over the ranks of a mesh (port of
``nerf_tpu/parallel/pose_dp.py``).

Pose refinement is parallel over images: each image's rays touch only its
own se(3) twist. The images and their base poses shard over the ranks; the
twists of all N images, the shared log-focal and the optimizer state are
replicated. Each rank differentiates the photometric loss of its images
(the twist gradient is zero outside its rows), then one ``all_reduce_mean``
assembles the global gradient (``engine.pose_opt.mesh_grad_reduce``) and
the replicated update applies identically on every rank.

Each rank draws the pixels the serial loop draws for the same images: the
pixel streams are keyed by global image index
(``engine.pose_opt._sample_pixel_rays``'s ``image_index_offset``). The
render's own numbers (jitter, sigma noise, when the settings have them) are
folded with the rank, as in JAX.

The serial loops take the mesh themselves (``engine.pose_opt``'s
``make_pose_opt_loop`` / ``make_joint_train_loop``); the functions here
keep the JAX package's names and its check that the ranks divide the
images.
"""

from __future__ import annotations

from ..engine.pose_opt import make_joint_train_loop, make_pose_opt_loop
from ..engine.renderer import RenderSettings
from .mesh import Mesh


def _check_images(mesh: Mesh, num_images: int) -> None:
    if num_images % mesh.world_size:
        raise ValueError(f"num_images {num_images} not divisible by {mesh.world_size} ranks")


def make_parallel_pose_opt_loop(model_coarse, model_fine, settings: RenderSettings, height: int,
                                width: int, focal_length: float, rays_per_image: int,
                                steps_per_loop: int, mesh: Mesh, num_images: int,
                                refine_focal: bool = False):
    """``loop(state, base_poses (n, 4, 4), images (n, H, W, 3), base_seed,
    pixel_indices=None) -> (state, losses (K,))`` with this rank's ``n =
    num_images / world`` images (``mesh.shard_rows``) and the replicated
    state: ``engine.pose_opt.make_pose_opt_loop`` with the mesh, so it
    follows the serial trajectory. ``pixel_indices`` (K, n, R) replaces the
    pixel draws (tests)."""
    _check_images(mesh, num_images)
    return make_pose_opt_loop(model_coarse, model_fine, settings, height, width, focal_length,
                              rays_per_image, steps_per_loop, refine_focal=refine_focal,
                              mesh=mesh)


def make_parallel_joint_train_loop(model_coarse, model_fine, settings: RenderSettings,
                                   height: int, width: int, focal_length: float,
                                   rays_per_image: int, steps_per_loop: int, mesh: Mesh,
                                   num_images: int, refine_focal: bool = False,
                                   anchor_first: bool = True):
    """The data-parallel form of ``engine.pose_opt.make_joint_train_loop``
    (that loop with the mesh): ``loop(state, base_poses (n, 4, 4), images
    (n, H, W, 3), base_seed, pixel_indices=None) -> (state, losses (K,))``
    with this rank's images and the replicated NeRF weights, cameras and
    both optimizers."""
    _check_images(mesh, num_images)
    return make_joint_train_loop(model_coarse, model_fine, settings, height, width,
                                 focal_length, rays_per_image, steps_per_loop,
                                 refine_focal=refine_focal, anchor_first=anchor_first, mesh=mesh)

"""Data parallelism over the ranks of a ``torch.distributed`` process group
(one rank a device): ray-parallel training and rendering, the sharded
geometry sweep, pose refinement and multi-scene training, and the
process-group start-up (``torchrun``'s group, or spawned local ranks)."""

from .distributed import is_primary, maybe_initialize_distributed, run_ranks
from .dp import (
    make_parallel_image_render_fn,
    make_parallel_pose_render_fn,
    make_parallel_render_fn,
    make_parallel_train_loop,
    make_parallel_train_step,
)
from .geometry import make_parallel_sigma_grid_fn
from .mesh import (
    DATA_AXIS,
    Mesh,
    all_reduce_mean,
    gather_rows,
    make_mesh,
    pad_to_devices,
    replicate_params,
    shard_rows,
)
from .multiscene import (
    MultiSceneState,
    create_multiscene_state,
    make_multiscene_train_loop,
    make_multiscene_train_step,
    make_parallel_multiscene_train_loop,
    make_parallel_multiscene_train_step,
    sample_multiscene_batch,
    scene_generators,
    shard_multiscene_stores,
)
from .pose_dp import make_parallel_joint_train_loop, make_parallel_pose_opt_loop

__all__ = [
    "DATA_AXIS",
    "Mesh",
    "all_reduce_mean",
    "gather_rows",
    "is_primary",
    "make_mesh",
    "maybe_initialize_distributed",
    "pad_to_devices",
    "replicate_params",
    "run_ranks",
    "shard_rows",
    "make_parallel_image_render_fn",
    "make_parallel_pose_render_fn",
    "make_parallel_render_fn",
    "make_parallel_train_loop",
    "make_parallel_train_step",
    "make_parallel_joint_train_loop",
    "make_parallel_multiscene_train_loop",
    "make_parallel_multiscene_train_step",
    "make_parallel_pose_opt_loop",
    "make_parallel_sigma_grid_fn",
    "shard_multiscene_stores",
    "MultiSceneState",
    "create_multiscene_state",
    "make_multiscene_train_loop",
    "make_multiscene_train_step",
    "sample_multiscene_batch",
    "scene_generators",
]

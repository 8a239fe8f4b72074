"""Multi-scene training on one device; the multi-device modules of the JAX
package (mesh, data parallelism, distributed start-up) are not ported yet
(ROADMAP.md, open items §1 item 11)."""

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

__all__ = [
    "MultiSceneState",
    "create_multiscene_state",
    "make_multiscene_train_loop",
    "make_multiscene_train_step",
    "make_parallel_multiscene_train_loop",
    "make_parallel_multiscene_train_step",
    "sample_multiscene_batch",
    "scene_generators",
    "shard_multiscene_stores",
]

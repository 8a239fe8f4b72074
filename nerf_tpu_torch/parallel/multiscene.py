"""Multi-scene training: S scenes stepped as one batched workload (the
one-device half of ``nerf_tpu/parallel/multiscene.py``).

Every scene has its own parameters, optimizer moments and random stream;
they share the model shape, the render settings and the step count. The
parameters of all scenes are stacked on a leading ``(S,)`` axis, one leaf
per parameter of the ``coarse`` and ``fine`` modules, and one step runs
every scene: ``torch.func.vmap`` over ``torch.func.functional_call`` of the
modules through ``engine.renderer.render_rays``, where the JAX package
vmaps its train step. The losses of the scenes are summed and
back-propagated once: the scenes share nothing, so each stacked leaf's
gradient slice is that scene's own gradient. The optimizer is the
configured ``torch.optim`` rule over the stacked leaves; every rule the port
has is elementwise, so it updates each scene as the scene's own optimizer
would, and the shared ``LambdaLR`` is each scene's schedule. As in the JAX
step there is no gradient clipping (it would couple the scenes) and no
non-finite skip.

Random numbers: under ``vmap`` one generator cannot feed the scenes
independently, so each scene's numbers are drawn before the vmapped body
from its own generator and passed in (``engine.renderer.RenderDraws``).
The loop seeds scene ``s``'s generator of step ``t`` with
``fold_seed(fold_seed(base_seed, s), t)`` and draws its ray batch and then
its render numbers from it, in the single-scene loop's order: scene ``s`` of
``make_multiscene_train_loop(..., base_seed)`` takes the steps of
``engine.train.make_train_loop(..., fold_seed(base_seed, s))`` on its own
store, whatever S is and whatever the other scenes are.

The field: with ``use_pallas_train`` set and a model the training kernels
take (FlexibleNeRF 4x128, PaperNeRF 8x256), the renderer's dispatch reaches
#8 or #9 inside the vmapped body, and their autograd function's ``vmap``
rule (``kernels/train_vjp.py``) runs every scene in one scene-batched
forward launch and one backward launch a field evaluation: the scene is a
grid axis of the kernels, as ``pallas_call``'s batching rule makes it one in
the JAX step. Otherwise the plain field runs, vmapped. ``use_pallas`` (the
forward-only kernels, which carry no gradient) is turned off, as JAX's
``make_loss_fn`` and the single-scene step turn it off. The
``train_multiscene`` CLI sets neither flag, as the JAX CLI does not
(``train_multiscene.py:250-256``).

Data parallelism (the JAX package's ``shard_map`` around the vmapped step):
each scene's ray batch shards over the ranks of a mesh on the ray axis
(``shard_multiscene_stores``), the stacked state is replicated, and one
``all_reduce_mean`` of every (S, ...) gradient leaf and the (S,) losses runs
between the backward and the update. Rank r's scene s draws step t's rays
and render numbers from ``fold_seed(fold_seed(fold_seed(base_seed, s), t),
r)``.
"""

from __future__ import annotations

import copy
import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
from torch import nn

from ..engine.renderer import (
    RenderDraws,
    RenderSettings,
    draw_render_randoms,
    render_rays,
)
from ..engine.train import (
    OptimizerSpec,
    StepMetrics,
    fold_seed,
    sample_ray_batch,
    step_generator,
)
from ..ops.math import img2mse, mse2psnr
from .mesh import Mesh, shard_rows


@dataclasses.dataclass
class MultiSceneState:
    """The state of S scenes: ``params`` maps ``coarse.<name>`` and
    ``fine.<name>`` to a leaf of shape (S, *parameter shape); ``step`` is
    shared, as the JAX loop reads ``state.step[0]``."""

    step: int
    params: Dict[str, torch.Tensor]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR

    def scene_params(self, s: int, which: str = "coarse") -> Dict[str, torch.Tensor]:
        """Scene ``s``'s state dict of the ``which`` module (a copy, detached)."""
        prefix = which + "."
        return {k[len(prefix):]: v[s].detach().clone() for k, v in self.params.items()
                if k.startswith(prefix)}


class _ScenePair(nn.Module):
    """The coarse and fine modules under one name space, so one
    ``functional_call`` swaps in a scene's parameters for both."""

    def __init__(self, model_coarse: nn.Module, model_fine: Optional[nn.Module]):
        super().__init__()
        self.coarse = model_coarse
        self.fine = model_fine

    def forward(self, ro, rd, settings: RenderSettings, draws: RenderDraws):
        return render_rays(self.coarse, self.fine, ro, rd, settings, draws=draws)


def create_multiscene_state(model_coarse: nn.Module, model_fine: Optional[nn.Module],
                            optimizer: OptimizerSpec, seed: int, num_scenes: int,
                            device=None) -> MultiSceneState:
    """A state whose every leaf has a leading ``(num_scenes,)`` axis: scene
    ``s``'s coarse and then fine parameters are ``reset_parameters`` on the
    CPU from a generator seeded with ``fold_seed(seed, s)`` (the JAX package
    splits its key per scene), so every device starts from the same
    weights."""
    if device is None:
        device = next(model_coarse.parameters()).device
    scenes = []
    for s in range(num_scenes):
        gen = torch.Generator().manual_seed(fold_seed(seed, s))
        pair = _ScenePair(copy.deepcopy(model_coarse).cpu(),
                          copy.deepcopy(model_fine).cpu() if model_fine is not None else None)
        for model in (pair.coarse, pair.fine):
            if model is not None:
                model.reset_parameters(gen)
        scenes.append(dict(pair.named_parameters()))
    params = {name: torch.stack([sc[name].detach() for sc in scenes]).to(device)
              .requires_grad_(True) for name in scenes[0]}
    for p in params.values():
        p.grad = torch.zeros_like(p)
    opt, sched = optimizer.init(list(params.values()))
    return MultiSceneState(0, params, opt, sched)


def stack_draws(draws: Sequence[RenderDraws]) -> RenderDraws:
    """Per-scene draws stacked on a leading scene axis."""
    return RenderDraws(*(None if field[0] is None else torch.stack(field)
                         for field in zip(*draws)))


def make_multiscene_train_step(model_coarse: nn.Module, model_fine: Optional[nn.Module],
                               settings: RenderSettings, mesh: Optional[Mesh] = None
                               ) -> Callable[..., Tuple[MultiSceneState, StepMetrics]]:
    """Build the scene-vmapped training step.

    ``step(state, ro (S, B, 3), rd (S, B, 3), target (S, B, 3),
    generators=None, draws=None) -> (state, StepMetrics of (S,) tensors)``:
    each scene's render numbers come from ``draws`` (a ``RenderDraws`` with
    a leading scene axis) or, drawn here, from ``generators[s]``. The
    modules give the shapes and the forward; their own parameters are not
    used. ``use_pallas_train`` runs the field through the training kernels,
    all scenes in one launch each way; ``use_pallas`` is turned off (no
    gradient). With a ``mesh``, the rays are this rank's and one all-reduce
    of the stacked gradients and the (S,) losses runs between the backward
    and the update."""
    settings = dataclasses.replace(settings, use_pallas=False)
    # Copies: the JAX CLI passes one model as both (untied parameters here).
    pair = _ScenePair(copy.deepcopy(model_coarse),
                      copy.deepcopy(model_fine) if model_fine is not None else None)

    def scene_losses(params, ro, rd, target, draws):
        out = torch.func.functional_call(pair, params, (ro, rd, settings, draws))
        coarse = img2mse(out.coarse.rgb, target)
        fine = img2mse(out.fine.rgb, target) if out.fine is not None else torch.zeros_like(coarse)
        return coarse + fine, coarse, fine

    def batched(params, ro, rd, target, draws: RenderDraws):
        # The settings draw nothing for some fields: those are not mapped.
        dims = RenderDraws(*(None if f is None else 0 for f in draws))
        return torch.func.vmap(scene_losses, in_dims=(0, 0, 0, 0, dims),
                               randomness="error")(params, ro, rd, target, draws)

    def step(state: MultiSceneState, ro, rd, target,
             generators: Optional[Sequence[torch.Generator]] = None,
             draws: Optional[RenderDraws] = None):
        if draws is None:
            if generators is None:
                generators = [None] * ro.shape[0]
            draws = stack_draws([draw_render_randoms(g, ro.shape[1], settings, ro.device)
                                 for g in generators])
        state.optimizer.zero_grad(set_to_none=False)
        loss, closs, floss = batched(state.params, ro, rd, target, draws)
        loss.sum().backward()
        losses = torch.stack([loss.detach(), closs.detach(), floss.detach()])
        if mesh is not None:
            mesh.all_reduce_mean([p.grad for p in state.params.values()] + [losses])
        state.optimizer.step()
        state.scheduler.step()
        state.step += 1
        loss, closs, floss = losses
        return state, StepMetrics(loss, closs, floss, mse2psnr(loss))

    return step


def scene_generators(base_seed: int, step: int, num_scenes: int, device,
                     rank: Optional[int] = None) -> List[torch.Generator]:
    """Step ``step``'s generator of each scene: scene ``s``'s is the
    single-scene loop's ``step_generator(fold_seed(base_seed, s), step)``;
    on rank ``rank`` of a mesh, its seed folded with the rank."""
    return [step_generator(fold_seed(base_seed, s), step, device, rank)
            for s in range(num_scenes)]


def make_multiscene_train_loop(model_coarse: nn.Module, model_fine: Optional[nn.Module],
                               settings: RenderSettings, batch_size: int,
                               steps_per_call: int, sample_mode: str = "gather",
                               mesh: Optional[Mesh] = None):
    """``loop(state, ro (S, N, 3), rd (S, N, 3), tgt (S, N, 3), base_seed) ->
    (state, StepMetrics of (steps_per_call, S) device tensors)``: each step
    draws every scene's batch from its store on the device, then steps
    them all at once.

    ``mesh``: data-parallel over its ranks, with this rank's store slices
    (``shard_multiscene_stores``) and ``batch_size`` the per-scene GLOBAL
    batch; each step draws ``batch_size / world`` rays a scene, on more than
    one rank with ``scene_generators(..., rank=mesh.rank)``."""
    world = 1 if mesh is None else mesh.world_size
    if batch_size % world:
        raise ValueError(f"per-scene batch {batch_size} not divisible by {world} ranks")
    local_batch = batch_size // world
    rank_fold = mesh.rank if world > 1 else None
    step_fn = make_multiscene_train_step(model_coarse, model_fine, settings, mesh)

    def loop(state: MultiSceneState, ro_store, rd_store, tgt_store, base_seed: int):
        metrics = []
        for _ in range(steps_per_call):
            gens = scene_generators(base_seed, state.step, ro_store.shape[0], ro_store.device,
                                    rank_fold)
            batch = sample_multiscene_batch(gens, ro_store, rd_store, tgt_store, local_batch,
                                            mode=sample_mode)
            state, m = step_fn(state, *batch, generators=gens)
            metrics.append(m)
        return state, StepMetrics(*(torch.stack(field) for field in zip(*metrics)))

    return loop


def sample_multiscene_batch(generators: Sequence[Optional[torch.Generator]],
                            ray_origins: torch.Tensor, ray_directions: torch.Tensor,
                            targets: torch.Tensor, batch_size: int, mode: str = "gather"
                            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Independent (S, B, 3) ray batches of (S, N, 3) per-scene stores,
    scene ``s``'s drawn from ``generators[s]`` as
    ``engine.train.sample_ray_batch`` draws one scene's (``gather``: rows
    with replacement; ``sliced``: one offset and the rows after it, which
    needs pre-shuffled stores)."""
    if len(generators) != ray_origins.shape[0]:
        raise ValueError(f"{len(generators)} generators for {ray_origins.shape[0]} scenes")
    parts = [sample_ray_batch(g, ray_origins[s], ray_directions[s], targets[s], batch_size,
                              mode=mode) for s, g in enumerate(generators)]
    return tuple(torch.stack(field) for field in zip(*parts))


def shard_multiscene_stores(mesh: Mesh, *arrays):
    """This rank's slice of (S, N, ...) per-scene stores on the RAY axis (1):
    every rank holds every scene's rays [r N / W, (r + 1) N / W), the JAX
    ``P(None, axis)`` layout. N must divide by the world."""
    return shard_rows(mesh, *arrays, axis=1)


def make_parallel_multiscene_train_step(model_coarse: nn.Module,
                                        model_fine: Optional[nn.Module],
                                        settings: RenderSettings, mesh: Mesh):
    """The data-parallel scene-vmapped step on this rank's ``b = B / world``
    rays of each scene's global batch: ``make_multiscene_train_step`` with
    the mesh. With perturbation and sigma noise off it matches the
    one-device step on the union batch (a mean of equal-size rank means is
    the global mean)."""
    return make_multiscene_train_step(model_coarse, model_fine, settings, mesh)


def make_parallel_multiscene_train_loop(model_coarse: nn.Module,
                                        model_fine: Optional[nn.Module],
                                        settings: RenderSettings, mesh: Mesh, batch_size: int,
                                        steps_per_call: int, sample_mode: str = "gather"):
    """The data-parallel loop on this rank's store slices, ``batch_size``
    the per-scene GLOBAL batch: ``make_multiscene_train_loop`` with the
    mesh."""
    return make_multiscene_train_loop(model_coarse, model_fine, settings, batch_size,
                                      steps_per_call, sample_mode=sample_mode, mesh=mesh)

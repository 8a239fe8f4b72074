"""Training engine: optimizer, LR schedule, train step, ray batching (port of
``nerf_tpu/engine/train.py``).

Behaviour kept from the JAX package (and the reference):
  - loss = MSE(coarse) + MSE(fine) on the ray batch, PSNR from the combined
    loss;
  - per-step exponential LR decay lr * factor^(t / (lr_decay * 1000)), t the
    number of updates applied (``optax.exponential_decay``, staircase off);
  - the optimizer picked by its ``torch.optim`` name from the config, with
    optax's rule and defaults (``engine/optimizers.py`` where torch's differ);
  - optional global-norm gradient clipping (``optax.clip_by_global_norm``)
    and a non-finite guard that skips an update.

PyTorch runs eagerly, so the JAX package's one compiled program per K steps
becomes a Python loop over K steps whose metrics stay on the device and are
fetched once per call. The state is the two modules, a ``torch.optim``
optimizer over ``list(coarse.parameters()) + list(fine.parameters())`` (the
reference's parameter order, so its ``state_dict`` is the reference
checkpoint's ``optimizer_state_dict``) and a ``LambdaLR`` schedule stepped
after each update. Random numbers come from a ``torch.Generator`` seeded from
(base seed, step) for each step, where JAX folds the step into a key.
"""

from __future__ import annotations

import dataclasses
import difflib
from typing import Callable, List, NamedTuple, Optional, Tuple

import torch
from torch import nn

from ..ops.math import img2mse, mse2psnr
from ..utils.profiling import TRAIN_BACKWARD, TRAIN_DRAW, TRAIN_FORWARD, TRAIN_UPDATE, annotate
from .optimizers import OPTAX_RULES
from .renderer import RenderSettings, render_rays

_ADAM_BETAS = (0.9, 0.999)
_ADAM_EPS = 1e-8
_ADAMW_WEIGHT_DECAY = 1e-4   # optax.adamw's default (torch.optim.AdamW's is 1e-2)

# The JAX package's names (its optax table), and the torch.optim names it
# refuses with a reason (nerf_tpu/engine/train.py:73-106).
OPTIMIZER_NAMES = ("adam", "adamw", "sgd") + tuple(OPTAX_RULES)
_NO_EQUIVALENT = {
    "asgd": "averaged SGD has no optax equivalent; 'sgd' is nearest",
    "lbfgs": "L-BFGS needs a line-search-driven update loop "
             "(optax.lbfgs) incompatible with the fixed train step; use 'adam'",
    "sparseadam": "JAX arrays are dense; use 'adam'",
}


def exponential_lr_schedule(initial_lr: float, lr_decay: float,
                            lr_decay_factor: float) -> Callable[[int], float]:
    """``t -> lr * factor^(t / transition)`` with ``transition =
    int(lr_decay * 1000)`` (reference train_nerf.py:264-270); a constant
    ``lr`` when ``transition`` is not positive, as optax does."""
    transition = int(lr_decay * 1000)

    def schedule(step: int) -> float:
        if transition <= 0:
            return float(initial_lr)
        return float(initial_lr) * float(lr_decay_factor) ** (step / transition)

    return schedule


@dataclasses.dataclass(frozen=True)
class OptimizerSpec:
    """A ``torch.optim`` rule by name, its LR schedule and its gradient
    clipping: the counterpart of the JAX package's optax transformation.
    ``init(params)`` builds the optimizer and the schedule over ``params``."""

    name: str
    lr: float
    lr_decay: Optional[float] = None
    lr_decay_factor: Optional[float] = None
    grad_clip_norm: Optional[float] = None

    def schedule(self, step: int) -> float:
        if self.lr_decay and self.lr_decay_factor and self.name != "rprop":
            return exponential_lr_schedule(self.lr, self.lr_decay, self.lr_decay_factor)(step)
        return float(self.lr)

    def init(self, params: List[nn.Parameter]
             ) -> Tuple[torch.optim.Optimizer, torch.optim.lr_scheduler.LambdaLR]:
        """Optimizer and schedule over ``params``, before any update."""
        if self.name == "adam":
            opt = torch.optim.Adam(params, lr=self.lr, betas=_ADAM_BETAS, eps=_ADAM_EPS)
        elif self.name == "adamw":
            opt = torch.optim.AdamW(params, lr=self.lr, betas=_ADAM_BETAS, eps=_ADAM_EPS,
                                    weight_decay=_ADAMW_WEIGHT_DECAY)
        elif self.name == "sgd":
            opt = torch.optim.SGD(params, lr=self.lr, momentum=0.0)
        else:
            opt = OPTAX_RULES[self.name](params, lr=self.lr)
        return opt, self.make_scheduler(opt)

    def make_scheduler(self, opt: torch.optim.Optimizer, count: int = 0
                       ) -> torch.optim.lr_scheduler.LambdaLR:
        """The schedule over ``opt``, positioned after ``count`` updates: the
        next update uses ``schedule(count)``."""
        for group in opt.param_groups:
            group["initial_lr"] = float(self.lr)
        return torch.optim.lr_scheduler.LambdaLR(
            opt, lambda t: self.schedule(t) / self.lr, last_epoch=count - 1)


def make_optimizer(optimizer_type: str, lr: float, lr_decay: Optional[float] = None,
                   lr_decay_factor: Optional[float] = None,
                   grad_clip_norm: Optional[float] = None) -> OptimizerSpec:
    """An optimizer by its (reference ``torch.optim``) name, with optax's
    rule and defaults: ``adam``, ``adamw`` and ``sgd`` on ``torch.optim``
    (optax's rules; AdamW with optax's weight decay 1e-4), the seven others
    on ``engine/optimizers.py``. ``rprop`` takes ``lr`` as its initial step
    size and ignores the decay, as the JAX package does. Other names raise
    the JAX package's ``ValueError``, with its reason or the nearest name.
    """
    name = optimizer_type.lower()
    if name not in OPTIMIZER_NAMES:
        hint = _NO_EQUIVALENT.get(name)
        if hint is None:
            close = difflib.get_close_matches(name, OPTIMIZER_NAMES, n=1)
            hint = f"did you mean {close[0]!r}?" if close else None
        raise ValueError(f"Unsupported optimizer {optimizer_type!r}; available: "
                         f"{sorted(OPTIMIZER_NAMES)}" + (f" ({hint})" if hint else ""))
    return OptimizerSpec(name, float(lr), lr_decay, lr_decay_factor,
                         float(grad_clip_norm) if grad_clip_norm else None)


@dataclasses.dataclass
class TrainState:
    """The training state: ``step`` counts steps taken (updates applied or
    skipped by the non-finite guard)."""

    step: int
    model_coarse: nn.Module
    model_fine: Optional[nn.Module]
    optimizer: torch.optim.Optimizer
    scheduler: torch.optim.lr_scheduler.LambdaLR
    grad_clip_norm: Optional[float] = None

    @property
    def params(self) -> List[nn.Parameter]:
        return self.optimizer.param_groups[0]["params"]


def create_train_state(model_coarse: nn.Module, model_fine: Optional[nn.Module],
                       optimizer: OptimizerSpec, step: int = 0) -> TrainState:
    """State over already-initialized modules, at step ``step``; the
    parameters in the reference's order, coarse then fine."""
    params = list(model_coarse.parameters())
    if model_fine is not None:
        params += list(model_fine.parameters())
    for p in params:
        p.grad = torch.zeros_like(p)
    opt, sched = optimizer.init(params)
    return TrainState(step, model_coarse, model_fine, opt, sched, optimizer.grad_clip_norm)


class StepMetrics(NamedTuple):
    loss: torch.Tensor
    coarse_loss: torch.Tensor
    fine_loss: torch.Tensor
    psnr: torch.Tensor


def make_loss_fn(model_coarse, model_fine, settings: RenderSettings):
    """The training loss: MSE(coarse) + MSE(fine) of the rendered ray batch.

    Returns ``loss_fn(ro, rd, target, generator) -> (loss, (coarse, fine))``.
    The forward-only kernel (``use_pallas``) is off: it has no gradient. The
    training kernels (``use_pallas_train``) carry one.
    """
    settings = dataclasses.replace(settings, use_pallas=False)

    def loss_fn(ro, rd, target, generator=None):
        out = render_rays(model_coarse, model_fine, ro, rd, settings, generator)
        coarse_loss = img2mse(out.coarse.rgb, target)
        fine_loss = (img2mse(out.fine.rgb, target) if out.fine is not None
                     else torch.zeros((), device=coarse_loss.device))
        return coarse_loss + fine_loss, (coarse_loss, fine_loss)

    return loss_fn


def all_finite(loss: torch.Tensor, grads) -> torch.Tensor:
    """A device bool: the loss and every gradient are finite."""
    finite = torch.isfinite(loss)
    for g in grads:
        finite = finite & torch.isfinite(g).all()
    return finite


def clip_by_global_norm(grads, max_norm: float) -> None:
    """``optax.clip_by_global_norm`` in place: scale every gradient by
    ``max_norm / ||g||`` when the global norm ``||g|| >= max_norm``."""
    norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
    keep = norm < max_norm
    for g in grads:
        g.copy_(torch.where(keep, g, g / norm * max_norm))


def make_train_step(model_coarse, model_fine, settings: RenderSettings,
                    nan_guard: bool = False, mesh=None):
    """``step(state, ro (B, 3), rd (B, 3), target (B, 3), generator) ->
    (state, StepMetrics)``: render, loss, backward, optional clipping, update.

    ``nan_guard``: on a non-finite loss or gradient skip the update, so the
    parameters, the optimizer's moments and the schedule's count stay as they
    were; only ``state.step`` moves. It reads one flag from the device per
    step.

    ``mesh`` (``parallel.mesh.Mesh``): the data-parallel step on this rank's
    rays. One ``all_reduce_mean`` of the gradients and the three losses (the
    JAX ``lax.pmean``) runs between the backward and the guard, so every
    rank guards, clips and updates with the same numbers and no two ranks
    part. The metrics are then the global batch's.
    """
    loss_fn = make_loss_fn(model_coarse, model_fine, settings)

    def train_step(state: TrainState, ro, rd, target, generator=None):
        with annotate(TRAIN_FORWARD):
            loss, (closs, floss) = loss_fn(ro, rd, target, generator)
        with annotate(TRAIN_BACKWARD):
            state.optimizer.zero_grad(set_to_none=False)
            loss.backward()
        with annotate(TRAIN_UPDATE):
            grads = [p.grad for p in state.params]
            loss, closs, floss = loss.detach(), closs.detach(), floss.detach()
            if mesh is not None:
                losses = torch.stack([loss, closs, floss])
                mesh.all_reduce_mean(grads + [losses])
                loss, closs, floss = losses
            update = True
            if nan_guard:
                update = bool(all_finite(loss, grads))
            if update:
                if state.grad_clip_norm:
                    clip_by_global_norm(grads, state.grad_clip_norm)
                state.optimizer.step()
                state.scheduler.step()
            state.step += 1
            metrics = StepMetrics(loss, closs, floss, mse2psnr(loss))
        return state, metrics

    return train_step


def fold_seed(seed: int, i: int) -> int:
    """A seed derived from (seed, i), where JAX folds ``i`` into a key."""
    return (int(seed) * 1_000_003 + int(i)) % (2**63 - 1)


def step_generator(base_seed: int, step: int, device, rank: Optional[int] = None
                   ) -> torch.Generator:
    """The generator of one step: seeded from (base seed, step) alone, so
    resume and replay draw the same numbers whatever the steps per call;
    with ``rank``, that seed folded with the rank (a data-parallel rank's
    own draws, JAX ``dp.py:145``)."""
    seed = fold_seed(base_seed, step)
    if rank is not None:
        seed = fold_seed(seed, rank)
    return torch.Generator(device=device).manual_seed(seed)


def make_train_loop(model_coarse, model_fine, settings: RenderSettings, batch_size: int,
                    steps_per_call: int, nan_guard: bool = False, sample_mode: str = "gather",
                    mesh=None):
    """``loop(state, ro_store, rd_store, tgt_store, base_seed) -> (state,
    StepMetrics of (steps_per_call,) device tensors)``: ``steps_per_call``
    steps, each drawing its ray batch from the device-resident store.

    ``mesh``: data-parallel over its ranks, with this rank's slice of the
    store and ``batch_size`` the GLOBAL batch; each step draws ``batch_size
    / world`` rays and takes ``make_train_step``'s all-reducing step. On
    more than one rank, step t's generator is seeded with
    ``fold_seed(fold_seed(base_seed, t), rank)``, as the JAX loop folds the
    shard index into the step key; on one rank the draws are the serial
    loop's.
    """
    world = 1 if mesh is None else mesh.world_size
    if batch_size % world:
        raise ValueError(f"global batch {batch_size} not divisible by {world} ranks")
    local_batch = batch_size // world
    rank_fold = mesh.rank if world > 1 else None
    step_fn = make_train_step(model_coarse, model_fine, settings, nan_guard=nan_guard,
                              mesh=mesh)

    def loop(state: TrainState, ro_store, rd_store, tgt_store, base_seed: int):
        metrics = []
        for _ in range(steps_per_call):
            with annotate(TRAIN_DRAW):
                gen = step_generator(base_seed, state.step, ro_store.device, rank_fold)
                ro, rd, tgt = sample_ray_batch(gen, ro_store, rd_store, tgt_store, local_batch,
                                               mode=sample_mode)
            state, m = step_fn(state, ro, rd, tgt, gen)
            metrics.append(m)
        return state, StepMetrics(*(torch.stack(field) for field in zip(*metrics)))

    return loop


def sample_ray_batch(generator: Optional[torch.Generator], ray_origins: torch.Tensor,
                     ray_directions: torch.Tensor, targets: torch.Tensor, batch_size: int,
                     mode: str = "gather") -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``batch_size`` rays of a flat (N, 3) store, drawn on the store's device.

    ``gather``: independent uniform rows, with replacement. ``sliced``: one
    uniform offset in [0, N - B] and the B rows after it (needs a shuffled
    store, ``data.rays_store.shuffle_ray_store``).
    """
    n = ray_origins.shape[0]
    device = ray_origins.device
    if mode == "sliced":
        if n < batch_size:
            raise ValueError(f"sliced sampling needs store size >= batch ({n} < {batch_size})")
        off = torch.randint(n - batch_size + 1, (1,), generator=generator, device=device)
        idx = off + torch.arange(batch_size, device=device)
    elif mode == "gather":
        idx = torch.randint(n, (batch_size,), generator=generator, device=device)
    else:
        raise ValueError(f"unknown ray-sampling mode {mode!r}")
    return ray_origins[idx], ray_directions[idx], targets[idx]


def steps_per_call(print_every: int, validate_every: int, save_every: int,
                   remaining: int) -> int:
    """Steps per loop call: the shortest of the three cadences, never more
    than the steps left (``train_nerf.py:402-410`` of the JAX CLI)."""
    return max(1, min(int(print_every), int(validate_every), int(save_every), int(remaining)))


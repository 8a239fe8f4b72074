"""optax's update rules as ``torch.optim`` optimizers, for the seven names
whose ``torch.optim`` namesake computes something else (the JAX package maps
every name onto optax, ``nerf_tpu/engine/train.py:56-113``).

Each class runs optax 0.2's rule with optax's defaults, operation for
operation in float32, on each parameter: ``direction`` is what the rule's
``scale_by_*`` transformation gives, and ``step`` applies ``p + (-lr) *
direction`` as ``scale_by_learning_rate`` and ``apply_updates`` do. The
group's ``lr`` is the schedule's value at the update count, which
``engine.train.OptimizerSpec``'s ``LambdaLR`` keeps current. Where
``torch.optim`` differs:

- ``rmsprop``: optax decays by 0.9 (torch 0.99) and puts eps inside the
  root, ``g / sqrt(nu + eps)``;
- ``adagrad``: the accumulator starts at 0.1 (torch 0), eps 1e-7 sits
  inside the root, and there is no lr decay;
- ``adamax``: ``nu = max(|g| + eps, b2 nu)`` as in torch, but the update is
  ``mu_hat / nu`` with no eps added afterwards;
- ``adadelta``: the lr is the caller's (torch defaults to 1.0), rho 0.9,
  eps 1e-6;
- ``nadam``: optax's Nesterov Adam (``scale_by_adam(nesterov=True)``), with
  no momentum-decay schedule (torch's ``momentum_decay`` 4e-3);
- ``radam``: the rectified step once ``rho_t >= 5`` (torch switches at
  ``> 5``), before that the bias-corrected ``mu`` alone;
- ``rprop``: a fixed lr seeds every step size (the schedule is ignored, as
  the JAX package does), steps bounded to [1e-6, 50] as in torch; but optax
  0.2 applies the signed step it stored on the previous update (torch the
  new one), so its first update moves nothing.

The state of each parameter holds optax's slots under ``SLOTS`` (the Adam
family's ``mu``/``nu`` under torch's ``exp_avg``/``exp_avg_sq``, and the
update count under ``step``), so a ``.ntc`` checkpoint's optax state maps
onto it slot by slot (``engine/checkpoint.py``).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

# optax's names for the slots of each name's state, and the state key each
# has in this package ("count" is the rule's own update count).
TORCH_KEY = {"count": "step", "mu": "exp_avg", "nu": "exp_avg_sq"}


def _f32(x) -> float:
    """A scalar rounded to float32, as optax's scalars are."""
    return float(np.float32(x))


def _pow(x: float, n: int) -> np.float32:
    """``x ** n`` for a count ``n`` in float32 as the JAX trainer's compiled
    step gives it: the float32 ``x`` raised in float64, rounded once."""
    return np.float32(np.float64(np.float32(x)) ** int(n))


def _bias(decay: float, count: float) -> float:
    """``1 - decay ** count`` in float32 (``optax.tree.bias_correction``)."""
    return _f32(np.float32(1.0) - _pow(decay, count))


class _OptaxRule(torch.optim.Optimizer):
    """One optax rule over ``params``; subclasses name their slots and give
    ``direction``."""

    SLOTS: Tuple[str, ...] = ()     # optax's slot names, in its state's order
    COUNTED = False                 # the rule keeps an update count
    DEFAULTS: Dict[str, float] = {}

    def __init__(self, params, lr: float, **hyper):
        super().__init__(params, dict(self.DEFAULTS, lr=lr, **hyper))

    def initial_slot(self, name: str, p: torch.Tensor, group) -> torch.Tensor:
        """A slot's value before the first update (``init_fn``)."""
        return torch.zeros_like(p, memory_format=torch.preserve_format)

    def direction(self, g: torch.Tensor, state, group) -> torch.Tensor:
        raise NotImplementedError

    def scale(self, group) -> float:
        """What the direction is multiplied by: ``-lr`` in float32."""
        return -_f32(group["lr"])

    @torch.no_grad()
    def step(self, closure=None):
        loss = None
        if closure is not None:
            with torch.enable_grad():
                loss = closure()
        for group in self.param_groups:
            scale = self.scale(group)
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    for name in self.SLOTS:
                        state[TORCH_KEY.get(name, name)] = self.initial_slot(name, p, group)
                    if self.COUNTED:
                        state["step"] = torch.zeros((), dtype=torch.float32)
                if self.COUNTED:
                    state["step"] += 1
                p.add_(self.direction(p.grad, state, group) * scale)
        return loss


class OptaxRMSprop(_OptaxRule):
    """``optax.rmsprop``: ``nu = 0.1 g^2 + 0.9 nu``, ``g / sqrt(nu + eps)``."""

    SLOTS = ("nu",)
    DEFAULTS = {"decay": 0.9, "eps": 1e-8}

    def direction(self, g, state, group):
        nu = state["exp_avg_sq"]
        nu.copy_((1.0 - group["decay"]) * g ** 2 + group["decay"] * nu)
        return torch.rsqrt(nu + group["eps"]) * g


class OptaxAdagrad(_OptaxRule):
    """``optax.adagrad``: the sum of squares from 0.1, ``g / sqrt(sum + eps)``
    where the sum is positive."""

    SLOTS = ("sum_of_squares",)
    DEFAULTS = {"initial_accumulator_value": 0.1, "eps": 1e-7}

    def initial_slot(self, name, p, group):
        return torch.full_like(p, group["initial_accumulator_value"])

    def direction(self, g, state, group):
        acc = state["sum_of_squares"]
        acc.copy_(g * g + acc)
        inv = torch.where(acc > 0, torch.rsqrt(acc + group["eps"]), torch.zeros_like(acc))
        return inv * g


class OptaxAdamax(_OptaxRule):
    """``optax.adamax``: ``nu = max(|g| + eps, b2 nu)``, ``mu_hat / nu``."""

    SLOTS = ("count", "mu", "nu")
    COUNTED = True
    DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}

    def direction(self, g, state, group):
        mu, nu = state["exp_avg"], state["exp_avg_sq"]
        b1 = group["b1"]
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_(torch.maximum(g.abs() + group["eps"], group["b2"] * nu))
        return (mu / _bias(b1, float(state["step"]))) / nu


class OptaxAdadelta(_OptaxRule):
    """``optax.adadelta``: ``sqrt(e_x + eps) / sqrt(e_g + eps) g``, then
    ``e_x`` tracks the squared direction."""

    SLOTS = ("e_g", "e_x")
    DEFAULTS = {"rho": 0.9, "eps": 1e-6}

    def direction(self, g, state, group):
        e_g, e_x = state["e_g"], state["e_x"]
        rho, eps = group["rho"], group["eps"]
        e_g.copy_((1.0 - rho) * g ** 2 + rho * e_g)
        d = torch.sqrt(e_x + eps) / torch.sqrt(e_g + eps) * g
        e_x.copy_((1.0 - rho) * d ** 2 + rho * e_x)
        return d


class _OptaxAdamFamily(_OptaxRule):
    SLOTS = ("count", "mu", "nu")
    COUNTED = True
    DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8}

    def moments(self, g, state, group):
        """Update ``mu`` and ``nu`` (``tree.update_moment*``) and return them."""
        mu, nu = state["exp_avg"], state["exp_avg_sq"]
        b1, b2 = group["b1"], group["b2"]
        mu.copy_((1.0 - b1) * g + b1 * mu)
        nu.copy_((1.0 - b2) * g ** 2 + b2 * nu)
        return mu, nu


class OptaxNAdam(_OptaxAdamFamily):
    """``optax.nadam``: ``mu_hat = b1 mu / (1 - b1^(t+1)) + (1 - b1) g /
    (1 - b1^t)``, ``mu_hat / (sqrt(nu_hat) + eps)``."""

    def direction(self, g, state, group):
        mu, nu = self.moments(g, state, group)
        t, b1 = float(state["step"]), group["b1"]
        mu_hat = b1 * (mu / _bias(b1, t + 1)) + (1.0 - b1) * (g / _bias(b1, t))
        nu_hat = nu / _bias(group["b2"], t)
        return mu_hat / (torch.sqrt(nu_hat) + group["eps"])


class OptaxRAdam(_OptaxAdamFamily):
    """``optax.radam``: Adam's step scaled by the rectification ``r`` once
    ``rho_t >= 5``, the bias-corrected ``mu`` before."""

    DEFAULTS = {"b1": 0.9, "b2": 0.999, "eps": 1e-8, "threshold": 5.0}

    def direction(self, g, state, group):
        mu, nu = self.moments(g, state, group)
        t, b1, b2 = float(state["step"]), group["b1"], group["b2"]
        mu_hat = mu / _bias(b1, t)
        # optax's scalars: ro_inf a Python float, the rest float32; rho_t
        # cancels 1999 - 1994 at t = 5, so every rounding is optax's.
        ro_inf = 2.0 / (1.0 - b2) - 1.0
        b2t = _pow(b2, t)
        ro = np.float32(ro_inf) - np.float32(2 * int(t)) * b2t / (np.float32(1.0) - b2t)
        if ro < group["threshold"]:
            return mu_hat
        r = np.sqrt((ro - np.float32(4.0)) * (ro - np.float32(2.0)) * np.float32(ro_inf)
                    / (np.float32((ro_inf - 4.0) * (ro_inf - 2.0)) * ro))
        nu_hat = nu / _bias(b2, t)
        return _f32(r) * mu_hat / (torch.sqrt(nu_hat) + group["eps"])


class OptaxRprop(_OptaxRule):
    """``optax.rprop``: per-element step sizes from ``lr``, grown by 1.2 while
    ``g`` keeps the stored step's sign and shrunk by 0.5 when it flips,
    clipped to [1e-6, 50]. The direction is the step stored on the previous
    update (optax 0.2's order), zero where the sign flipped."""

    SLOTS = ("step_sizes", "prev_updates")
    DEFAULTS = {"eta_minus": 0.5, "eta_plus": 1.2, "min_step_size": 1e-6,
                "max_step_size": 50.0}

    def initial_slot(self, name, p, group):
        if name == "step_sizes":
            return torch.full_like(p, group["lr"])
        return torch.zeros_like(p)

    def scale(self, group) -> float:
        return -1.0        # optax chains the rule with scale(-1), not the lr

    def direction(self, g, state, group):
        sizes, prev = state["step_sizes"], state["prev_updates"]
        sign = g * prev
        grown = torch.where(sign > 0, torch.full_like(sizes, group["eta_plus"]),
                            torch.full_like(sizes, group["eta_minus"]))
        new_sizes = torch.where(sign == 0, sizes, torch.clamp(
            sizes * grown, min=group["min_step_size"], max=group["max_step_size"]))
        zero = torch.zeros_like(g)
        applied = torch.where(sign < 0, zero, prev)
        prev.copy_(torch.where(sign < 0, zero, new_sizes * torch.sign(g)))
        sizes.copy_(new_sizes)
        return applied


OPTAX_RULES = {
    "rmsprop": OptaxRMSprop,
    "adagrad": OptaxAdagrad,
    "adamax": OptaxAdamax,
    "adadelta": OptaxAdadelta,
    "nadam": OptaxNAdam,
    "radam": OptaxRAdam,
    "rprop": OptaxRprop,
}

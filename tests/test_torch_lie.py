"""nerf_tpu_torch.lie against nerf_tpu.lie: every map on the same seeded
f32 batches (generic angles, angles under and around the Taylor threshold,
angles at and near pi), and the gradients of the Exp maps at theta -> 0
against JAX's autodiff."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nerf_tpu import lie as jlie
from nerf_tpu_torch import lie as tlie

TOL = 2e-6


def _axes(n, seed):
    a = np.random.default_rng(seed).standard_normal((n, 3))
    return a / np.linalg.norm(a, axis=1, keepdims=True)


def _omegas(kind, seed=0):
    """(n, 3) f32 axis-angle vectors of one angle regime."""
    axes = _axes(8, seed)
    if kind == "generic":
        return (np.random.default_rng(seed).standard_normal((8, 3)) * 0.8).astype(np.float32)
    angles = {"zero": [0.0] * 8,
              "tiny": [1e-9, 1e-7, 1e-6, 1e-5, 3e-5, 9e-5, 9.9e-5, 5e-5],
              "threshold": [1.01e-4, 1.1e-4, 2e-4, 5e-4, 1e-3, 1e-2, 0.1, 0.5],
              "near_pi": [np.pi, np.pi - 1e-5, np.pi - 1e-4, np.pi - 5e-4, np.pi - 9e-4,
                          np.pi - 2e-3, np.pi - 0.1, 3.0]}[kind]
    return (axes * np.asarray(angles)[:, None]).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=tol, atol=tol)


KINDS = ["generic", "zero", "tiny", "threshold", "near_pi"]


@pytest.mark.parametrize("kind", KINDS)
def test_so3_maps_match_jax(kind):
    w = _omegas(kind)
    _close(tlie.so3_hat(torch.from_numpy(w)), jlie.so3_hat(jnp.asarray(w)), 0)
    K = np.array(jlie.so3_hat(jnp.asarray(w)))
    _close(tlie.so3_vee(torch.from_numpy(K)), jlie.so3_vee(jnp.asarray(K)), 0)
    R_want = jlie.so3_exp(jnp.asarray(w))
    R_got = tlie.so3_exp(torch.from_numpy(w))
    _close(R_got, R_want)
    # Log of the same rotation matrices (JAX's, so the inputs are bitwise equal).
    R = np.array(R_want)
    tol = 1e-3 if kind == "near_pi" else TOL   # arccos near trace = -1: ~sqrt(eps_f32)
    _close(tlie.so3_log(torch.from_numpy(R)), jlie.so3_log(jnp.asarray(R)), tol)


def test_so3_log_branch_near_pi_recovers_the_axis():
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)[None]
    w = tlie.so3_log(torch.from_numpy(R))[0].numpy()
    np.testing.assert_allclose(np.abs(w), [np.pi, 0, 0], atol=1e-5)
    _close(tlie.so3_log(torch.from_numpy(R)), jlie.so3_log(jnp.asarray(R)), 0)
    # exp(log(R)) = R at 179.999 and 180 degrees (tests/test_lie.py's angles)
    w_in = (_axes(2, 3) * np.deg2rad([[179.999], [180.0]])).astype(np.float32)
    R = tlie.so3_exp(torch.from_numpy(w_in))
    np.testing.assert_allclose(tlie.so3_exp(tlie.so3_log(R)).numpy(), R.numpy(), atol=1e-3)


@pytest.mark.parametrize("kind", KINDS)
def test_se3_maps_match_jax(kind):
    w = _omegas(kind, seed=1)
    v = np.random.default_rng(2).standard_normal((8, 3)).astype(np.float32)
    xi = np.concatenate([v, w], axis=1)
    _close(tlie.se3_hat(torch.from_numpy(xi)), jlie.se3_hat(jnp.asarray(xi)), 0)
    X = np.array(jlie.se3_hat(jnp.asarray(xi)))
    _close(tlie.se3_vee(torch.from_numpy(X)), jlie.se3_vee(jnp.asarray(X)), 0)
    T_want = jlie.se3_exp(jnp.asarray(xi))
    _close(tlie.se3_exp(torch.from_numpy(xi)), T_want)
    _close(tlie._left_jacobian(torch.from_numpy(w)), jlie._left_jacobian(jnp.asarray(w)))
    T = np.array(T_want)
    tol = 2e-3 if kind == "near_pi" else 1e-5
    _close(tlie.se3_log(torch.from_numpy(T)), jlie.se3_log(jnp.asarray(T)), tol)


@pytest.mark.parametrize("kind", ["zero", "tiny", "threshold", "generic"])
def test_exp_gradients_match_jax(kind):
    """The gradients of sum(weights * Exp(x)) at small and generic angles:
    finite, and equal to JAX's autodiff through its Taylor branches."""
    w = _omegas(kind, seed=4)
    xi = np.concatenate([np.full_like(w, 0.3), w], axis=1)
    rng = np.random.default_rng(5)
    c3, c4 = rng.standard_normal((3, 3)).astype(np.float32), \
        rng.standard_normal((4, 4)).astype(np.float32)
    for tmap, jmap, x, c in ((tlie.so3_exp, jlie.so3_exp, w, c3),
                             (tlie.se3_exp, jlie.se3_exp, xi, c4)):
        want = jax.grad(lambda a: jnp.sum(jmap(a) * c))(jnp.asarray(x))
        xt = torch.from_numpy(x).requires_grad_(True)
        (got,) = torch.autograd.grad((tmap(xt) * torch.from_numpy(c)).sum(), xt)
        assert torch.isfinite(got).all()
        _close(got, want, 1e-5)


def test_exp_at_zero_and_pure_translation():
    np.testing.assert_allclose(tlie.so3_exp(torch.zeros(2, 3)).numpy(), np.stack([np.eye(3)] * 2),
                               atol=1e-6)
    T = tlie.se3_exp(torch.tensor([[1.0, 2.0, 3.0, 0.0, 0.0, 0.0]]))[0].numpy()
    np.testing.assert_allclose(T[:3, :3], np.eye(3), atol=1e-6)
    np.testing.assert_allclose(T[:3, 3], [1, 2, 3], atol=1e-6)
    np.testing.assert_allclose(T[3], [0, 0, 0, 1])

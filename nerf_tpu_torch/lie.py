"""SO(3) / SE(3) Lie-group operations for pose optimization (port of
``nerf_tpu/lie.py``).

hat/vee and Exp/Log for SO(3) and SE(3), with small-angle Taylor branches
below ``_TAYLOR_THRESHOLD``. Gradients come from autograd through the
guarded closed forms: each branch is evaluated at a safe angle where the
other one is taken (``torch.where`` on a substituted argument, not on the
result alone), so both values and gradients stay finite as theta -> 0.

Every function takes (..., 3[, 3]) or (..., 6 / 4, 4) batches.
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8
_TAYLOR_THRESHOLD = 1e-4


def _safe_theta(omega: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(omega * omega, dim=-1) + _EPS * _EPS)


def so3_hat(omega: torch.Tensor) -> torch.Tensor:
    """(..., 3) axis-angle vector -> (..., 3, 3) skew matrix."""
    wx, wy, wz = omega[..., 0], omega[..., 1], omega[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], -1),
            torch.stack([wz, zeros, -wx], -1),
            torch.stack([-wy, wx, zeros], -1),
        ],
        dim=-2,
    )


def so3_vee(Omega: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew matrix -> (..., 3) vector."""
    return torch.stack([Omega[..., 2, 1], Omega[..., 0, 2], Omega[..., 1, 0]], dim=-1)


def _taylor_guarded(theta: torch.Tensor, exact, taylor) -> torch.Tensor:
    """``exact(theta)`` where theta >= the threshold, ``taylor(theta)`` below
    it; ``exact`` sees 1 in place of the small angles."""
    small = theta < _TAYLOR_THRESHOLD
    theta_safe = torch.where(small, torch.ones_like(theta), theta)
    return torch.where(small, taylor(theta), exact(theta_safe))


def _sin_theta_by_theta(theta: torch.Tensor) -> torch.Tensor:
    """sin(theta) / theta."""
    return _taylor_guarded(theta, lambda t: torch.sin(t) / t, lambda t: 1.0 - t ** 2 / 6.0)


def _one_minus_cos_by_theta_sq(theta: torch.Tensor) -> torch.Tensor:
    """(1 - cos(theta)) / theta^2."""
    return _taylor_guarded(theta, lambda t: (1.0 - torch.cos(t)) / (t ** 2),
                           lambda t: 0.5 - t ** 2 / 24.0)


def _theta_minus_sin_by_theta_cubed(theta: torch.Tensor) -> torch.Tensor:
    """(theta - sin(theta)) / theta^3."""
    return _taylor_guarded(theta, lambda t: (t - torch.sin(t)) / (t ** 3),
                           lambda t: 1.0 / 6.0 - t ** 2 / 120.0)


def _eye_like(K: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=K.dtype, device=K.device).expand(K.shape)


def so3_exp(omega: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula: axis-angle (..., 3) -> rotation matrix (..., 3, 3)."""
    theta = _safe_theta(omega)[..., None, None]
    K = so3_hat(omega)
    return _eye_like(K) + _sin_theta_by_theta(theta) * K + _one_minus_cos_by_theta_sq(theta) * (K @ K)


def so3_log(R: torch.Tensor) -> torch.Tensor:
    """Rotation matrix (..., 3, 3) -> axis-angle (..., 3).

    Three branches:
      * theta ~ 0: first-order Taylor of theta / (2 sin theta);
      * generic: vee(antisymmetric part) * theta / sin(theta);
      * theta ~ pi: the antisymmetric part cancels, so the axis comes from
        the symmetric part, R = 2 n n^T - I at theta = pi: n_i^2 =
        (R_ii + 1) / 2 and R_ij + R_ji = 4 n_i n_j. One axis candidate per
        pivot i (n_i positive, the others from the off-diagonals); the
        candidate whose pivot has the largest diagonal is taken, its sign
        chosen to agree with vee(antisym).
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)

    antisym = 0.5 * (R - R.transpose(-1, -2))
    sin_theta = torch.sin(theta)[..., None]
    small = theta[..., None] < _TAYLOR_THRESHOLD
    generic_scale = theta[..., None] / torch.where(sin_theta < _EPS, torch.ones_like(sin_theta),
                                                   sin_theta)
    scale = torch.where(small, 1.0 + theta[..., None] ** 2 / 6.0, generic_scale)
    w_generic = so3_vee(antisym) * scale

    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    n_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    sym = {
        (0, 1): R[..., 0, 1] + R[..., 1, 0],
        (0, 2): R[..., 0, 2] + R[..., 2, 0],
        (1, 2): R[..., 1, 2] + R[..., 2, 1],
    }

    def candidate(pivot: int) -> torch.Tensor:
        denom = torch.clamp(4.0 * n_abs[..., pivot], min=_EPS)
        comps = [n_abs[..., pivot] if j == pivot else sym[(min(pivot, j), max(pivot, j))] / denom
                 for j in range(3)]
        return torch.stack(comps, dim=-1)

    candidates = torch.stack([candidate(0), candidate(1), candidate(2)], dim=-2)
    k = torch.argmax(diag, dim=-1)
    axis = torch.take_along_dim(candidates, k[..., None, None], dim=-2)[..., 0, :]
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    v = so3_vee(antisym)
    sign = torch.where(torch.sum(v * axis, dim=-1, keepdim=True) < 0.0, -1.0, 1.0)
    w_pi = axis * sign * theta[..., None]

    near_pi = (math.pi - theta[..., None]) < 1e-3
    return torch.where(near_pi, w_pi, w_generic)


def se3_hat(xi: torch.Tensor) -> torch.Tensor:
    """(..., 6) twist [v, omega] -> (..., 4, 4) matrix."""
    v, omega = xi[..., :3], xi[..., 3:]
    top = torch.cat([so3_hat(omega), v[..., :, None]], dim=-1)
    return torch.cat([top, torch.zeros_like(top[..., :1, :])], dim=-2)


def se3_vee(Xi: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) -> (..., 6) twist."""
    return torch.cat([Xi[..., :3, 3], so3_vee(Xi[..., :3, :3])], dim=-1)


def _left_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l (SE(3) Exp's translation part)."""
    theta = _safe_theta(omega)[..., None, None]
    K = so3_hat(omega)
    return (_eye_like(K) + _one_minus_cos_by_theta_sq(theta) * K
            + _theta_minus_sin_by_theta_cubed(theta) * (K @ K))


def _homogeneous_bottom(top: torch.Tensor) -> torch.Tensor:
    """(..., 3, 4) -> (..., 4, 4) with the row [0, 0, 0, 1]."""
    bottom = torch.zeros_like(top[..., :1, :])
    bottom[..., 0, 3] = 1.0
    return torch.cat([top, bottom], dim=-2)


def se3_exp(xi: torch.Tensor) -> torch.Tensor:
    """Twist (..., 6) [v, omega] -> rigid transform (..., 4, 4)."""
    v, omega = xi[..., :3], xi[..., 3:]
    R = so3_exp(omega)
    t = (_left_jacobian(omega) @ v[..., :, None])[..., 0]
    return _homogeneous_bottom(torch.cat([R, t[..., :, None]], dim=-1))


def se3_log(T: torch.Tensor) -> torch.Tensor:
    """Rigid transform (..., 4, 4) -> twist (..., 6) [v, omega]."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    omega = so3_log(R)
    v = torch.linalg.solve(_left_jacobian(omega), t[..., :, None])[..., 0]
    return torch.cat([v, omega], dim=-1)

"""SO(3)/SE(3) utilities, batched over leading axes
(visualslam_tpu/geometry/se3.py).

Rotations are 3x3 matrices; tangent increments are 6-vectors [omega, v]
applied as left-multiplied exponentials. The small-angle and near-pi
branches are masked with `torch.where` over safe denominators, exactly as
the JAX package masks them, so no value of a tensor ever picks a Python
branch (no host sync).
"""

from __future__ import annotations

import math

import torch

_EPS = 1e-8


def _eye3(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def hat(w: torch.Tensor) -> torch.Tensor:
    """[..., 3] -> [..., 3, 3] skew-symmetric."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], -1),
        torch.stack([wz, z, -wx], -1),
        torch.stack([-wy, wx, z], -1),
    ], -2)


def _exp_coeffs(w: torch.Tensor):
    """(a, b, c) = (sin t/t, (1-cos t)/t^2, (t-sin t)/t^3) as [..., 1, 1];
    the branch variable is t^2 = |w|^2 and sqrt only sees values >= eps."""
    t2 = (w * w).sum(-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    th = torch.sqrt(t2s)
    a = torch.where(small, 1.0 - t2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - t2 / 24.0, (1.0 - torch.cos(th)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - t2 / 120.0,
                    (th - torch.sin(th)) / (t2s * th))
    return a, b, c


def exp_so3(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues: [..., 3] axis-angle -> [..., 3, 3] rotation."""
    W = hat(w)
    a, b, _ = _exp_coeffs(w)
    return _eye3(w) + a * W + b * (W @ W)


def log_so3(R: torch.Tensor) -> torch.Tensor:
    """[..., 3, 3] rotation -> [..., 3] axis-angle (principal branch).
    Near the identity theta/(2 sin theta) is a series in u = 1 - cos;
    near pi the axis comes from the diagonal."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    cos = torch.clamp((tr - 1.0) / 2.0, -1.0, 1.0)
    u = 1.0 - cos
    small = u < 1e-6
    cos_safe = torch.where(small, torch.zeros_like(cos), cos)
    theta = torch.arccos(cos_safe)
    w_vec = torch.stack([
        R[..., 2, 1] - R[..., 1, 2],
        R[..., 0, 2] - R[..., 2, 0],
        R[..., 1, 0] - R[..., 0, 1],
    ], -1)
    s = torch.sin(theta)[..., None]
    factor_small = 0.5 + u[..., None] / 6.0
    factor_large = theta[..., None] / torch.where(
        s < _EPS, torch.ones_like(s), 2.0 * s)
    w = torch.where(small[..., None], factor_small, factor_large) * w_vec
    near_pi = theta > math.pi - 1e-3
    diag = R.diagonal(dim1=-2, dim2=-1)
    axis = torch.sqrt(torch.clamp_min((diag + 1.0) / 2.0, 0.0))
    one = torch.ones_like(cos)
    sign_y = torch.where(R[..., 0, 1] < 0, -one, one)
    sign_z = torch.where(R[..., 0, 2] < 0, -one, one)
    axis = axis * torch.stack([one, sign_y, sign_z], -1)
    axis = axis / torch.clamp_min(
        torch.linalg.vector_norm(axis, dim=-1, keepdim=True), _EPS)
    return torch.where(near_pi[..., None], axis * theta[..., None], w)


def se3_exp(xi: torch.Tensor):
    """[..., 6] twist [omega, v] -> (R [..., 3, 3], t [..., 3]);
    t = V(omega) v with the SE(3) left Jacobian V."""
    w, v = xi[..., :3], xi[..., 3:]
    W = hat(w)
    W2 = W @ W
    a, b, c = _exp_coeffs(w)
    eye = _eye3(xi)
    R = eye + a * W + b * W2
    V = eye + b * W + c * W2
    return R, (V @ v[..., None])[..., 0]


def se3_log(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """Inverse of se3_exp -> [..., 6] twist."""
    w = log_so3(R)
    W = hat(w)
    t2 = (w * w).sum(-1)[..., None, None]
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    theta = torch.sqrt(t2s)
    s = torch.sin(theta)
    coeff = torch.where(
        small, 1.0 / 12.0 + t2 / 720.0,
        1.0 / t2s - (1.0 + torch.cos(theta)) / torch.where(
            small, torch.ones_like(t2), 2.0 * theta * s))
    Vinv = _eye3(R) - 0.5 * W + coeff * (W @ W)
    return torch.cat([w, (Vinv @ t[..., None])[..., 0]], -1)


def compose(Ra, ta, Rb, tb):
    """(Ra, ta) . (Rb, tb): apply b then a."""
    return Ra @ Rb, (Ra @ tb[..., None])[..., 0] + ta


def inverse(R, t):
    Rt = R.transpose(-1, -2)
    return Rt, -(Rt @ t[..., None])[..., 0]


def transform(R, t, X):
    """Apply [..., 3, 3], [..., 3] to points [..., 3]."""
    return (R @ X[..., None])[..., 0] + t


def relative(Ra, ta, Rb, tb):
    """T_ab = T_a^-1 . T_b (pose of b in a's frame)."""
    return compose(*inverse(Ra, ta), Rb, tb)

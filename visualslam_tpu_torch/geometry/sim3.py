"""Sim(3): similarity transforms for monocular scale drift
(visualslam_tpu/geometry/sim3.py).

Group element S = (R, t, s) acting on points as X -> s R X + t. Tangent:
7-vector xi = [omega (3), nu (3), sigma (1)]; exp uses the closed-form
Sim(3) "W" matrix (t = W(omega, sigma) nu) with Taylor guards at theta -> 0
and sigma -> 0, masked with `torch.where` over safe denominators so that
forward-mode derivatives (torch.func.jacfwd) stay finite. `sim3_log`
inverts W in closed form (adjugate over determinant), which needs no
status check on the host. All ops batch over leading axes.
"""

from __future__ import annotations

import torch

from visualslam_tpu_torch.geometry.se3 import exp_so3, hat, log_so3

_EPS2 = 1e-8   # threshold on theta^2 / sigma^2 (squared quantities)


def _calc_w_coeffs(theta2: torch.Tensor, sigma: torch.Tensor):
    """Coefficients (A, B, C) of W = A Omega + B Omega^2 + C I as
    [..., 1, 1] factors: four analytic regimes (sigma ~ 0 or not) x
    (theta ~ 0 or not)."""
    small_t = theta2 < _EPS2
    small_s = sigma * sigma < _EPS2
    one = torch.ones_like(theta2)

    t2s = torch.where(small_t, one, theta2)                   # safe theta^2
    theta = torch.sqrt(t2s)
    sig_s = torch.where(small_s, one, sigma)                  # safe sigma
    es = torch.exp(sigma)                                     # scale e^sigma

    # --- sigma ~ 0 ---------------------------------------------------
    C_s0 = one + 0.5 * sigma
    A_s0_t0 = 0.5 + sigma / 6.0
    B_s0_t0 = torch.full_like(sigma, 1.0 / 6.0)
    A_s0 = torch.where(small_t, A_s0_t0, (1.0 - torch.cos(theta)) / t2s)
    B_s0 = torch.where(small_t, B_s0_t0,
                       (theta - torch.sin(theta)) / (t2s * theta))

    # --- sigma != 0 ---------------------------------------------------
    C_s = (es - 1.0) / sig_s
    sig2 = sig_s * sig_s
    A_s_t0 = ((sigma - 1.0) * es + 1.0) / sig2
    B_s_t0 = (es * (0.5 * sig2 - sigma + 1.0) - 1.0) / (sig2 * sig_s)
    a = es * torch.sin(theta)
    b = es * torch.cos(theta)
    c = theta2 + sigma * sigma
    c_safe = torch.where(c < _EPS2, one, c)
    A_s = torch.where(small_t, A_s_t0,
                      (a * sigma + (1.0 - b) * theta) / (theta * c_safe))
    B_s = torch.where(small_t, B_s_t0,
                      (C_s - ((b - 1.0) * sigma + a * theta) / c_safe) / t2s)

    A = torch.where(small_s, A_s0, A_s)[..., None, None]
    B = torch.where(small_s, B_s0, B_s)[..., None, None]
    C = torch.where(small_s, C_s0, C_s)[..., None, None]
    return A, B, C


def _calc_w(omega: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    W = hat(omega)
    W2 = W @ W
    A, B, C = _calc_w_coeffs((omega * omega).sum(-1), sigma)
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return A * W + B * W2 + C * eye


def _inv3(M: torch.Tensor) -> torch.Tensor:
    """Closed-form inverse of [..., 3, 3] (adjugate / determinant)."""
    c0 = torch.cross(M[..., 1, :], M[..., 2, :], dim=-1)
    c1 = torch.cross(M[..., 2, :], M[..., 0, :], dim=-1)
    c2 = torch.cross(M[..., 0, :], M[..., 1, :], dim=-1)
    det = (M[..., 0, :] * c0).sum(-1)
    return torch.stack([c0, c1, c2], -1) / det[..., None, None]


def sim3_exp(xi: torch.Tensor):
    """[..., 7] tangent [omega, nu, sigma] -> (R [..., 3, 3], t [..., 3],
    s [...])."""
    omega, nu, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    R = exp_so3(omega)
    t = (_calc_w(omega, sigma) @ nu[..., None])[..., 0]
    return R, t, torch.exp(sigma)


def sim3_log(R: torch.Tensor, t: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Inverse of sim3_exp -> [..., 7] tangent."""
    omega = log_so3(R)
    sigma = torch.log(s)
    nu = (_inv3(_calc_w(omega, sigma)) @ t[..., None])[..., 0]
    return torch.cat([omega, nu, sigma[..., None]], -1)


def compose(Ra, ta, sa, Rb, tb, sb):
    """(Ra, ta, sa) . (Rb, tb, sb): apply b then a.
    X -> sa Ra (sb Rb X + tb) + ta."""
    return (Ra @ Rb, sa[..., None] * (Ra @ tb[..., None])[..., 0] + ta,
            sa * sb)


def inverse(R, t, s):
    Rt = R.transpose(-1, -2)
    inv_s = 1.0 / s
    return Rt, -inv_s[..., None] * (Rt @ t[..., None])[..., 0], inv_s


def transform(R, t, s, X):
    """Apply the similarity to points [..., 3]."""
    return s[..., None] * (R @ X[..., None])[..., 0] + t


def relative(Ra, ta, sa, Rb, tb, sb):
    """S_ab = S_a^-1 . S_b (pose of b in a's frame)."""
    return compose(*inverse(Ra, ta, sa), Rb, tb, sb)


def from_se3(R, t):
    """Lift SE(3) -> Sim(3) with unit scale."""
    return R, t, torch.ones(R.shape[:-2], dtype=R.dtype, device=R.device)

"""Pose-only optimization: motion-only LM with Huber IRLS
(visualslam_tpu/backend/pnp.py).

Given 3D landmarks and their 2D observations in a new frame, refine the
camera pose with landmarks fixed: a damped 6x6 solve per iteration, a fixed
number of iterations, and a masked accept (no early exit and no host sync).

`refine_pose_jit` is the JAX package's jitted solve: on the card one
captured CUDA graph per shape key and set of the solve's constants
(`utils.graphs.GraphProgram`, seedless: the LM loop holds no host read,
so it captures whole); on the CPU the function itself.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualslam_tpu_torch.geometry import se3
from visualslam_tpu_torch.ops.cuda import KERNELS
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.precision import f32_matmul


class PnPResult(NamedTuple):
    R: torch.Tensor             # [3, 3]
    t: torch.Tensor             # [3]
    inliers: torch.Tensor       # [N] bool (reprojection error < threshold)
    num_inliers: torch.Tensor   # [] int32
    cost: torch.Tensor          # []


def _pose_residuals(R, t, X, uv):
    pc = X @ R.T + t
    z = torch.clamp_min(pc[:, 2], 1e-6)
    return pc[:, :2] / z[:, None] - uv, pc


def solve_masked(H: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """H^-1 b, NaN where H is singular (as jnp.linalg.solve gives a
    non-finite result there, which the LM's `new_cost < cost` rejects).
    `solve_ex` with check_errors=False, because `torch.linalg.solve`
    checks for singularity on the host and so waits for the device."""
    x, info = torch.linalg.solve_ex(H, b, check_errors=False)
    return torch.where((info == 0)[..., None], x,
                       torch.full_like(x, float("nan")))


def refine_pose(R0: torch.Tensor, t0: torch.Tensor, X: torch.Tensor,
                uv: torch.Tensor, valid: torch.Tensor, iters: int = 10,
                huber_delta: float = 5e-3, inlier_threshold: float = 6e-3,
                damping: float = 1e-4) -> PnPResult:
    """Motion-only LM. X: [N, 3] world points; uv: [N, 2] normalized-plane
    measurements; valid: [N]. Float32 matmuls (TF32 off), as the
    reference. Returns the refined pose and inlier stats."""
    f32_matmul()
    eye3 = torch.eye(3, dtype=X.dtype, device=X.device)
    eye6 = torch.eye(6, dtype=X.dtype, device=X.device)
    d = huber_delta

    def cost_fn(R, t):
        r, pc = _pose_residuals(R, t, X, uv)
        rn = torch.linalg.vector_norm(r, dim=-1)
        c = torch.where(rn <= d, 0.5 * rn * rn, d * (rn - 0.5 * d))
        c = torch.where(pc[:, 2] <= 1e-6, torch.full_like(c, d * d), c)
        return torch.where(valid, c, torch.zeros_like(c)).sum()

    def step(R, t, lam):
        r, pc = _pose_residuals(R, t, X, uv)
        inv_z = 1.0 / torch.clamp_min(pc[:, 2], 1e-6)
        zeros = torch.zeros_like(inv_z)
        dpi = torch.stack([
            torch.stack([inv_z, zeros, -pc[:, 0] * inv_z * inv_z], -1),
            torch.stack([zeros, inv_z, -pc[:, 1] * inv_z * inv_z], -1),
        ], -2)                                          # [N, 2, 3]
        dp_dxi = torch.cat([-se3.hat(pc), eye3.expand(pc.shape[0], 3, 3)],
                           -1)                          # [N, 3, 6]
        J = dpi @ dp_dxi                                # [N, 2, 6]
        rn = torch.linalg.vector_norm(r, dim=-1)
        w = torch.sqrt(torch.clamp(huber_delta / torch.clamp_min(rn, 1e-12),
                                   max=1.0))
        w = torch.where(valid & (pc[:, 2] > 1e-6), w, torch.zeros_like(w))
        Jw = J * w[:, None, None]
        rw = r * w[:, None]
        H = torch.einsum("nai,naj->ij", Jw, Jw) + lam * eye6
        b = -torch.einsum("nai,na->i", Jw, rw)
        dR, dt = se3.se3_exp(solve_masked(H, b))
        return dR @ R, dR @ t + dt

    R, t = R0, t0
    lam = torch.full((), damping, dtype=X.dtype, device=X.device)
    cost = cost_fn(R, t)
    for _ in range(iters):
        Rn, tn = step(R, t, lam)
        cn = cost_fn(Rn, tn)
        acc = cn < cost
        R = torch.where(acc, Rn, R)
        t = torch.where(acc, tn, t)
        cost = torch.where(acc, cn, cost)
        lam = torch.clamp(torch.where(acc, lam * 0.3, lam * 5.0), 1e-9, 1e4)

    r, pc = _pose_residuals(R, t, X, uv)
    err = torch.linalg.vector_norm(r, dim=-1)
    inl = valid & (err < inlier_threshold) & (pc[:, 2] > 1e-6)
    return PnPResult(R=R, t=t, inliers=inl,
                     num_inliers=inl.sum(dtype=torch.int32), cost=cost)


def _refine_pose(x: tuple, cfg: tuple) -> PnPResult:
    """x = (R0, t0, X, uv, valid); cfg = ((iters, huber_delta,
    inlier_threshold, damping), Kernels)."""
    return refine_pose(*x, *cfg[0])


_REFINE = GraphProgram(_refine_pose, seeded=False)


def refine_pose_jit(R0: torch.Tensor, t0: torch.Tensor, X: torch.Tensor,
                    uv: torch.Tensor, valid: torch.Tensor, iters: int = 10,
                    huber_delta: float = 5e-3, inlier_threshold: float = 6e-3,
                    damping: float = 1e-4) -> PnPResult:
    """refine_pose as one captured graph per shape key and constants (the
    JAX package traces the three float constants and keys on iters; here
    all four are part of the key); the result is the caller's (copies of
    the graph's outputs)."""
    return _REFINE((R0, t0, X, uv, valid),
                   ((iters, huber_delta, inlier_threshold, damping), KERNELS))


refine_pose_jit.program = _REFINE

"""Sliding-window bundle adjustment: damped Gauss-Newton with landmark
(Schur) elimination (visualslam_tpu/backend/ba.py, solver "schur_dense").

Observations are a fixed-capacity SoA (cam_idx, lm_idx, uv, valid); the
sparse sums are fixed-order segment sums (the JAX package's segment_sum;
`ops/cuda/segment.py`), the camera-landmark coupling Wd is dense
[C, L, 6, 3], 3x3 landmark blocks invert in closed form, the reduced
6C x 6C camera system solves dense, and Levenberg-Marquardt runs a fixed
number of iterations with a masked accept. Each sum adds a segment's rows
in ascending observation order, on the CPU (the plain version) and on the
card (the kernel) alike, so a solve repeats bit for bit on either device.
The CPU and the card still round float32 products apart (cuBLAS against
the CPU's BLAS): hold one device's results to the other's by tolerances.
`run_ba` builds the sums' plans (`BAPlans`) once per problem and passes
them down; the functions below build their own when called without.
`run_ba_jit` / `run_ba_packed_jit` (the JAX package's compiled programs)
replay the same LM loop from captured CUDA graphs on the card
(utils/graphs.LoopProgram) and are the eager functions on the CPU.

Three solvers, as the reference: "schur_dense" (the reduced 6C x 6C system
solved directly), "schur_cg" (the same system by Jacobi-preconditioned
conjugate gradients) and "schur_mf" (matrix-free: the coupling stays per
observation, [O, 6, 3], and the reduced system is only ever applied, by
gathers and segment sums, under block-Jacobi-preconditioned CG). Both CG
solvers follow `jax.scipy.sparse.linalg.cg` (`cg`): the stop test is carried
on the device, so a solve never waits for the host.

Conventions: world-to-camera poses (x_cam = R X + t), residuals on the
normalized image plane, left-multiplicative se(3) perturbation
exp(xi) . T with xi = [omega, v].
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualslam_tpu_torch.backend.pnp import solve_masked
from visualslam_tpu_torch.geometry import se3
from visualslam_tpu_torch.ops.cuda.segment import (
    SegmentPlan,
    segment_plan,
    segment_sum,
)
from visualslam_tpu_torch.utils.config import BAConfig
from visualslam_tpu_torch.utils.graphs import LoopProgram
from visualslam_tpu_torch.utils.precision import f32_matmul


class BAProblem(NamedTuple):
    """Fixed-capacity BA problem. C cameras, L landmarks, O observations."""

    R: torch.Tensor          # [C, 3, 3] world-to-camera rotations
    t: torch.Tensor          # [C, 3]
    X: torch.Tensor          # [L, 3] world points
    cam_idx: torch.Tensor    # [O] int32
    lm_idx: torch.Tensor     # [O] int32
    uv: torch.Tensor         # [O, 2] normalized-plane measurements
    obs_valid: torch.Tensor  # [O] bool
    cam_valid: torch.Tensor  # [C] bool
    lm_valid: torch.Tensor   # [L] bool


class BAPlans(NamedTuple):
    """The segment-sum plans of one problem's indices."""

    cam: SegmentPlan            # cam_idx over C cameras
    lm: SegmentPlan             # lm_idx over L landmarks
    pair: SegmentPlan | None    # cam_idx * L + lm_idx over C * L (dense Wd)


def ba_plans(cam_idx: torch.Tensor, lm_idx: torch.Tensor, C: int, L: int,
             pair: bool = True) -> BAPlans:
    """Plans of the camera, landmark and (with `pair`) pair indices, on
    the indices' device: built once per problem, used by every sum."""
    return BAPlans(segment_plan(cam_idx, C), segment_plan(lm_idx, L),
                   segment_plan(cam_idx * L + lm_idx, C * L) if pair
                   else None)


class BAResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    X: torch.Tensor
    cost: torch.Tensor          # final robust cost
    initial_cost: torch.Tensor
    lm_lambda: torch.Tensor


def _residuals_jacobians(p: BAProblem, R, t, X, huber_delta: float):
    """Per-observation residuals + Jacobians with sqrt-Huber IRLS weights.
    Returns (r [O,2], Jc [O,2,6], Jl [O,2,3], w [O]) already weight-scaled."""
    Rc = R[p.cam_idx]                                   # [O, 3, 3]
    pc = torch.einsum("oij,oj->oi", Rc, X[p.lm_idx]) + t[p.cam_idx]
    z = pc[:, 2]
    behind = z <= 1e-6
    zs = torch.where(behind, torch.ones_like(z), z)
    r = pc[:, :2] / zs[:, None] - p.uv                  # [O, 2]

    inv_z = 1.0 / zs
    zeros = torch.zeros_like(inv_z)
    dpi = torch.stack([
        torch.stack([inv_z, zeros, -pc[:, 0] * inv_z * inv_z], -1),
        torch.stack([zeros, inv_z, -pc[:, 1] * inv_z * inv_z], -1),
    ], -2)                                              # [O, 2, 3]
    eye = torch.eye(3, dtype=r.dtype, device=r.device)
    dp_dxi = torch.cat([-se3.hat(pc), eye.expand(pc.shape[0], 3, 3)], -1)
    Jc = dpi @ dp_dxi                                   # [O, 2, 6]
    Jl = dpi @ Rc                                       # [O, 2, 3]

    valid = p.obs_valid & ~behind
    rn = torch.linalg.vector_norm(r, dim=-1)
    huber = torch.sqrt(torch.clamp(huber_delta / torch.clamp_min(rn, 1e-12),
                                   max=1.0))
    w = torch.where(valid, huber, torch.zeros_like(huber))
    return r * w[:, None], Jc * w[:, None, None], Jl * w[:, None, None], w


def robust_cost(p: BAProblem, R, t, X, huber_delta: float) -> torch.Tensor:
    """Huber cost of the current state (for LM accept/reject)."""
    pc = torch.einsum("oij,oj->oi", R[p.cam_idx], X[p.lm_idx]) + t[p.cam_idx]
    z = pc[:, 2]
    behind = z <= 1e-6
    proj = pc[:, :2] / torch.where(behind, torch.ones_like(z), z)[:, None]
    r2 = ((proj - p.uv) ** 2).sum(-1)
    rn = torch.sqrt(r2)
    d = huber_delta
    cost = torch.where(rn <= d, 0.5 * r2, d * (rn - 0.5 * d))
    # out-of-front observations get a fixed penalty (keeps cost comparable)
    cost = torch.where(behind, torch.full_like(cost, d * d), cost)
    return torch.where(p.obs_valid, cost, torch.zeros_like(cost)).sum()


def _inv3x3(M: torch.Tensor) -> torch.Tensor:
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
    d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
    g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
    A = e * i - f * h
    B = c * h - b * i
    C = b * f - c * e
    D = f * g - d * i
    E = a * i - c * g
    F = c * d - a * f
    G = d * h - e * g
    H = b * g - a * h
    I = a * e - b * d
    det = a * A + b * D + c * G
    det = torch.where(det.abs() < 1e-12, torch.full_like(det, 1e-12), det)
    adj = torch.stack([
        torch.stack([A, B, C], -1),
        torch.stack([D, E, F], -1),
        torch.stack([G, H, I], -1),
    ], -2)
    return adj / det[..., None, None]


def normal_equations_mf(p: BAProblem, R, t, X, cfg: BAConfig,
                        plans: BAPlans | None = None):
    """Normal-equation factors with the camera-landmark coupling per
    observation (Wo [O, 6, 3]): the matrix-free solver applies the reduced
    system from them and never materializes it (O(O) memory at any
    scale).
    Returns (U [C,6,6], V [L,3,3], bc [C,6], bl [L,3], Wo [O,6,3])."""
    if plans is None:
        plans = ba_plans(p.cam_idx, p.lm_idx, R.shape[0], X.shape[0], False)
    r, Jc, Jl, _ = _residuals_jacobians(p, R, t, X, cfg.huber_delta)
    U = segment_sum(torch.einsum("oai,oaj->oij", Jc, Jc), plans.cam)
    V = segment_sum(torch.einsum("oai,oaj->oij", Jl, Jl), plans.lm)
    bc = -segment_sum(torch.einsum("oai,oa->oi", Jc, r), plans.cam)
    bl = -segment_sum(torch.einsum("oai,oa->oi", Jl, r), plans.lm)
    Wo = torch.einsum("oai,oaj->oij", Jc, Jl)            # [O, 6, 3]
    return U, V, bc, bl, Wo


def normal_equations(p: BAProblem, R, t, X, cfg: BAConfig,
                     plans: BAPlans | None = None):
    """Assemble (U [C,6,6], V [L,3,3], bc [C,6], bl [L,3], Wd [C,L,6,3]):
    normal_equations_mf's factors with the per-observation coupling
    summed over the fused (cam, lm) pair index."""
    C = R.shape[0]
    L = X.shape[0]
    if plans is None:
        plans = ba_plans(p.cam_idx, p.lm_idx, C, L)
    U, V, bc, bl, Wo = normal_equations_mf(p, R, t, X, cfg, plans)
    Wd = segment_sum(Wo, plans.pair).reshape(C, L, 6, 3)
    return U, V, bc, bl, Wd


def schur_camera_system(U, V, bc, bl, Wd, lam):
    """Reduced camera system. Returns (S [C,6,C,6], b [C,6],
    V_inv [L,3,3]); the caller damps S with lam * I."""
    C = U.shape[0]
    eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
    V_inv = _inv3x3(V + lam * eye3)                      # [L, 3, 3]
    Y = torch.einsum("clij,ljk->clik", Wd, V_inv)        # [C, L, 6, 3]
    S = -torch.einsum("clik,dljk->cidj", Y, Wd)          # [C, 6, C, 6]
    eyeC = torch.eye(C, dtype=U.dtype, device=U.device)
    S = S + torch.einsum("cd,cij->cidj", eyeC, U)        # U on the diagonal
    b = bc - torch.einsum("clik,lk->ci", Y, bl)          # [C, 6]
    return S, b, V_inv


def cg(matvec, b: torch.Tensor, precond, maxiter: int,
       tol: float = 1e-10) -> torch.Tensor:
    """Preconditioned conjugate gradients with the semantics of
    `jax.scipy.sparse.linalg.cg(matvec, b, M=precond, maxiter, tol)`: start
    from x0 = 0, r0 = b - A x0; iterate while r.r > tol^2 (b.b) (the
    unpreconditioned residual) and k < maxiter. The loop runs `maxiter`
    iterations on the device and freezes (x, r, p, gamma) with torch.where
    once the test fails, so nothing is read on the host; a frozen
    iteration's 0 / 0 never reaches the result (b = 0 gives zeros)."""
    atol2 = tol * tol * (b * b).sum()
    x = torch.zeros_like(b)
    r = b - matvec(x)
    p = precond(r)
    gamma = (r * p).sum()
    for _ in range(maxiter):
        live = (r * r).sum() > atol2
        Ap = matvec(p)
        alpha = gamma / (p * Ap).sum()
        x_ = x + alpha * p
        r_ = r - alpha * Ap
        z_ = precond(r_)
        gamma_ = (r_ * z_).sum()
        p_ = z_ + (gamma_ / gamma) * p
        x = torch.where(live, x_, x)
        r = torch.where(live, r_, r)
        p = torch.where(live, p_, p)
        gamma = torch.where(live, gamma_, gamma)
    return x


def solve_cameras(S, b, cam_valid, lam, cfg: BAConfig):
    """Damp, gauge-fix and solve the reduced 6C x 6C camera system: densely
    ("schur_dense"; a singular system gives NaN, which the LM accept
    rejects) or by Jacobi-preconditioned CG ("schur_cg")."""
    C = cam_valid.shape[0]
    frozen = ~cam_valid
    if cfg.fix_first_camera:
        frozen = frozen | (torch.arange(C, device=S.device) == 0)
    mask6 = (~frozen).to(S.dtype).repeat_interleave(6)
    eye = torch.eye(6 * C, dtype=S.dtype, device=S.device)
    S2 = S.reshape(6 * C, 6 * C) + lam * eye
    S2 = S2 * mask6[:, None] * mask6[None, :]
    S2 = S2 + torch.diag(1.0 - mask6)                    # identity on frozen
    b2 = b.reshape(-1) * mask6
    if cfg.solver == "schur_cg":
        inv_diag = 1.0 / torch.clamp_min(torch.diagonal(S2), 1e-12)
        return cg(lambda v: S2 @ v, b2, lambda v: inv_diag * v,
                  cfg.cg_iters).reshape(C, 6)
    return solve_masked(S2, b2).reshape(C, 6)


def backsub_landmarks(V_inv, bl, Wd, dc, lm_valid):
    """dl = V^-1 (bl - Wd^T dc), masked to valid landmarks."""
    WtD = torch.einsum("clij,ci->lj", Wd, dc)            # [L, 3]
    dl = torch.einsum("lij,lj->li", V_inv, bl - WtD)     # [L, 3]
    return dl * lm_valid[:, None]


def apply_increments(R, t, X, dc, dl):
    """Left-multiplicative pose update, additive point update."""
    dR, dt = se3.se3_exp(dc)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt, X + dl


def schur_matvec_mf(v, U, V_inv, Wo, cam_idx, lm_idx, lam, free6,
                    plans: BAPlans | None = None):
    """S v = (U + lam I) v - W V^-1 W^T v without materializing S or W: two
    gathers and two segment sums over the observations. v, free6: [C, 6]
    (free6 zero on frozen / gauge cameras, which act as identity)."""
    if plans is None:
        plans = ba_plans(cam_idx, lm_idx, U.shape[0], V_inv.shape[0], False)
    vm = v * free6
    a = torch.einsum("oij,oi->oj", Wo, vm[cam_idx])      # [O, 3] W^T v rows
    q = segment_sum(a, plans.lm)                         # [L, 3]
    y = torch.einsum("lij,lj->li", V_inv, q)             # V^-1 W^T v
    b = torch.einsum("oij,oj->oi", Wo, y[lm_idx])        # [O, 6]
    s = segment_sum(b, plans.cam)                        # [C, 6]
    Sv = torch.einsum("cij,cj->ci", U, vm) + lam * vm - s
    return Sv * free6 + v * (1.0 - free6)


def solve_cameras_mf(p: BAProblem, U, V_inv, bc, bl, Wo, lam,
                     cfg: BAConfig, plans: BAPlans):
    """Matrix-free CG on the reduced camera system, preconditioned by the
    block-Jacobi inverse of U + lam I (6x6 blocks by `inv_ex`: no status
    read on the host)."""
    C = U.shape[0]
    frozen = ~p.cam_valid
    if cfg.fix_first_camera:
        frozen = frozen | (torch.arange(C, device=U.device) == 0)
    free6 = (~frozen).to(U.dtype)[:, None].expand(C, 6)

    # reduced right-hand side b = bc - W V^-1 bl (the matvec's structure)
    ybl = torch.einsum("lij,lj->li", V_inv, bl)
    wyb = segment_sum(torch.einsum("oij,oj->oi", Wo, ybl[p.lm_idx]),
                      plans.cam)
    b = (bc - wyb) * free6

    eye6 = torch.eye(6, dtype=U.dtype, device=U.device)
    Ublk = torch.where(frozen[:, None, None], eye6, U + lam * eye6)
    Minv = torch.linalg.inv_ex(Ublk + 1e-8 * eye6, check_errors=False)[0]

    def mv(v):
        return schur_matvec_mf(v, U, V_inv, Wo, p.cam_idx, p.lm_idx, lam,
                               free6, plans)

    def prec(v):
        return torch.einsum("cij,cj->ci", Minv, v) * free6

    return cg(mv, b, prec, cfg.cg_iters) * free6


def backsub_landmarks_mf(p: BAProblem, V_inv, bl, Wo, dc, lm_valid,
                         plans: BAPlans):
    """dl = V^-1 (bl - W^T dc) through the per-observation coupling."""
    a = torch.einsum("oij,oi->oj", Wo, dc[p.cam_idx])
    WtD = segment_sum(a, plans.lm)
    dl = torch.einsum("lij,lj->li", V_inv, bl - WtD)
    return dl * lm_valid[:, None]


def ba_step(p: BAProblem, R, t, X, lam, cfg: BAConfig,
            plans: BAPlans | None = None):
    """One damped-GN (LM) step: returns proposed (R, t, X)."""
    if plans is None:
        plans = ba_plans(p.cam_idx, p.lm_idx, R.shape[0], X.shape[0],
                         cfg.solver != "schur_mf")
    if cfg.solver == "schur_mf":
        U, V, bc, bl, Wo = normal_equations_mf(p, R, t, X, cfg, plans)
        eye3 = torch.eye(3, dtype=U.dtype, device=U.device)
        V_inv = _inv3x3(V + lam * eye3)
        dc = solve_cameras_mf(p, U, V_inv, bc, bl, Wo, lam, cfg, plans)
        dl = backsub_landmarks_mf(p, V_inv, bl, Wo, dc, p.lm_valid, plans)
        return apply_increments(R, t, X, dc, dl)
    U, V, bc, bl, Wd = normal_equations(p, R, t, X, cfg, plans)
    S, b, V_inv = schur_camera_system(U, V, bc, bl, Wd, lam)
    dc = solve_cameras(S, b, p.cam_valid, lam, cfg)
    dl = backsub_landmarks(V_inv, bl, Wd, dc, p.lm_valid)
    return apply_increments(R, t, X, dc, dl)


def _ba_enter(p: BAProblem, cfg: BAConfig):
    """(aux, carry) of the LM loop: the sums' plans and the initial cost;
    the state, the damping and the cost."""
    plans = ba_plans(p.cam_idx, p.lm_idx, p.R.shape[0], p.X.shape[0],
                     cfg.solver != "schur_mf")
    lam = torch.full((), cfg.damping_init, dtype=p.X.dtype,
                     device=p.X.device)
    cost = robust_cost(p, p.R, p.t, p.X, cfg.huber_delta)
    return (plans, cost), (p.R, p.t, p.X, lam, cost)


def _ba_iteration(p: BAProblem, cfg: BAConfig, aux, carry):
    """One LM iteration: a damped GN step, its cost, the masked accept."""
    R, t, X, lam, cost = carry
    Rn, tn, Xn = ba_step(p, R, t, X, lam, cfg, aux[0])
    new_cost = robust_cost(p, Rn, tn, Xn, cfg.huber_delta)
    accept = new_cost < cost
    return (torch.where(accept, Rn, R), torch.where(accept, tn, t),
            torch.where(accept, Xn, X),
            torch.clamp(torch.where(accept, lam * cfg.damping_down,
                                    lam * cfg.damping_up), 1e-9, 1e6),
            torch.where(accept, new_cost, cost))


def _ba_result(p: BAProblem, cfg: BAConfig, aux, carry) -> BAResult:
    R, t, X, lam, cost = carry
    return BAResult(R=R, t=t, X=X, cost=cost, initial_cost=aux[1],
                    lm_lambda=lam)


def _pack(res: BAResult) -> torch.Tensor:
    return torch.cat([res.R.reshape(-1), res.t.reshape(-1),
                      res.X.reshape(-1), res.cost[None],
                      res.initial_cost[None]])


def run_ba(p: BAProblem, cfg: BAConfig) -> BAResult:
    """Levenberg-Marquardt loop (fixed iteration count, masked accept), at
    float32 matmul precision (TF32 off) as the reference."""
    f32_matmul()
    aux, carry = _ba_enter(p, cfg)
    for _ in range(cfg.iters):
        carry = _ba_iteration(p, cfg, aux, carry)
    return _ba_result(p, cfg, aux, carry)


def run_ba_packed(p: BAProblem, cfg: BAConfig) -> torch.Tensor:
    """run_ba with the result packed into ONE flat f32 tensor
    [C*9 R | C*3 t | L*3 X | cost | initial_cost] (one read-back)."""
    return _pack(run_ba(p, cfg))


# the JAX package's compiled programs: captured CUDA graphs on the card
# (utils/graphs.LoopProgram: an enter graph and a step graph per shape key
# and cfg), the eager functions on the CPU
run_ba_jit = LoopProgram(run_ba, _ba_enter, _ba_iteration, _ba_result)
run_ba_packed_jit = LoopProgram(
    run_ba_packed, _ba_enter, _ba_iteration,
    lambda p, cfg, aux, carry: _pack(_ba_result(p, cfg, aux, carry)))


def unpack_ba_result(packed, C: int, L: int):
    """Host-side inverse of run_ba_packed (numpy array or tensor):
    (R[C,3,3], t[C,3], X[L,3], cost, initial_cost) as numpy."""
    a = (packed.cpu().numpy() if isinstance(packed, torch.Tensor)
         else np.asarray(packed))
    o = C * 9
    R = a[:o].reshape(C, 3, 3)
    t = a[o:o + C * 3].reshape(C, 3)
    o += C * 3
    X = a[o:o + L * 3].reshape(L, 3)
    o += L * 3
    return R, t, X, float(a[o]), float(a[o + 1])

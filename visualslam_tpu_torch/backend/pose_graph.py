"""Pose-graph optimization: damped Gauss-Newton on SE(3) and Sim(3)
relative-pose constraints (visualslam_tpu/backend/pose_graph.py).

Fixed-capacity edge SoA; per-edge Jacobians by forward-mode autodiff of the
residual at the identity perturbation (`torch.func.jvp` of the batched
residual under `torch.func.vmap` over the unit directions, where the JAX
package uses jax.jacfwd under jax.vmap over edges);
the normal equations assembled with fixed-order segment sums over node and
(i, j) block-pair indices (`ops/cuda/segment.py`: each node's edges added
in ascending edge order, on the CPU and on the card alike, so a solve
repeats bit for bit; the plans are built once per optimize call); node 0
frozen as the gauge. Two solvers, as the
reference's `resolve_solver` picks them:

  "dense"  H [N*D, N*D] materialized and solved directly (`solve_ex`);
  "cg"     block-Jacobi-preconditioned conjugate gradients, H never
           materialized, a fixed `cg_iters` iterations with no early exit.

`LoopCloser.optimize` pads every graph to at least `max_nodes` = 256 nodes,
above the default `cg_threshold` = 192, so the default configuration runs
CG. The LM loops are Python loops with a masked accept on the device: no
value is read back inside them. Float32 matmuls (TF32 off), as the
reference.

SE(3) residual: r_e = log(Tm_e^-1 . T_i^-1 . T_j), perturbation
T_k <- exp(xi_k) T_k. Sim(3): the same with the measured translation
de-conjugated by the target node's current scale.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jvp, vmap

from visualslam_tpu_torch.geometry import se3, sim3
from visualslam_tpu_torch.ops.cuda.segment import (
    SegmentPlan,
    segment_plan,
    segment_sum,
)
from visualslam_tpu_torch.utils.config import PoseGraphConfig
from visualslam_tpu_torch.utils.precision import f32_matmul


class PoseGraph(NamedTuple):
    R: torch.Tensor           # [N, 3, 3] node rotations
    t: torch.Tensor           # [N, 3]
    node_valid: torch.Tensor  # [N] bool
    i: torch.Tensor           # [E] int source node
    j: torch.Tensor           # [E] int target node
    Rm: torch.Tensor          # [E, 3, 3] measured relative rotation (j in i)
    tm: torch.Tensor          # [E, 3]
    weight: torch.Tensor      # [E] scalar information weight
    edge_valid: torch.Tensor  # [E] bool


class PoseGraphResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor


class Sim3Graph(NamedTuple):
    R: torch.Tensor           # [N, 3, 3]
    t: torch.Tensor           # [N, 3]
    s: torch.Tensor           # [N] per-node scale
    node_valid: torch.Tensor  # [N]
    i: torch.Tensor           # [E] source node
    j: torch.Tensor           # [E] target node
    Rm: torch.Tensor          # [E, 3, 3] measured relative (j in i)
    tm: torch.Tensor          # [E, 3]
    sm: torch.Tensor          # [E] measured relative scale
    weight: torch.Tensor      # [E]
    edge_valid: torch.Tensor  # [E]


class Sim3GraphResult(NamedTuple):
    R: torch.Tensor
    t: torch.Tensor
    s: torch.Tensor
    cost: torch.Tensor
    initial_cost: torch.Tensor


# ---------------------------------------------------------------------------
# residuals and their Jacobians
# ---------------------------------------------------------------------------


def _edge_residual(xi_i, xi_j, Ri, ti, Rj, tj, Rm, tm):
    dRi, dti = se3.se3_exp(xi_i)
    dRj, dtj = se3.se3_exp(xi_j)
    Rrel, trel = se3.relative(dRi @ Ri, (dRi @ ti[..., None])[..., 0] + dti,
                              dRj @ Rj, (dRj @ tj[..., None])[..., 0] + dtj)
    Re, te = se3.compose(*se3.inverse(Rm, tm), Rrel, trel)
    return se3.se3_log(Re, te)


def _sim3_edge_residual(xi_i, xi_j, Ri, ti, si, Rj, tj, sj, Rm, tm, sm):
    Ri2, ti2, si2 = sim3.compose(*sim3.sim3_exp(xi_i), Ri, ti, si)
    Rj2, tj2, sj2 = sim3.compose(*sim3.sim3_exp(xi_j), Rj, tj, sj)
    Rrel, trel, srel = sim3.relative(Ri2, ti2, si2, Rj2, tj2, sj2)
    # the measurement was taken in j's era (metric s_j x the gauge's):
    # dividing by the CURRENT s_j inside the residual makes the edge exact
    # at the consistent solution (as the reference)
    Rmi, tmi, smi = sim3.inverse(Rm, tm / sj2[..., None], sm)
    return sim3.sim3_log(*sim3.compose(Rmi, tmi, smi, Rrel, trel, srel))


def _with_jacobians(residual, D: int, *edge_args):
    """(r [E, D], Ji [E, D, D], Jj [E, D, D]) of `residual` at the identity
    perturbation of both nodes, per edge: forward-mode products with the
    2D unit directions of (xi_i, xi_j), batched over the edges and, by
    vmap, over the directions (what jacfwd under a per-edge vmap computes;
    a per-edge function would see 0-d tensors, whose forward-mode tangents
    torch promotes to float64 under Python-scalar arithmetic)."""
    E = edge_args[0].shape[0]
    zero = edge_args[0].new_zeros(E, D)

    def f(xi_i, xi_j):
        return residual(xi_i, xi_j, *edge_args)

    def push(v):
        return jvp(f, (zero, zero), (v[:D].expand(E, D),
                                     v[D:].expand(E, D)))[1]

    J = vmap(push)(torch.eye(2 * D, dtype=zero.dtype, device=zero.device))
    J = J.permute(1, 2, 0)                               # [E, D, 2D]
    return f(zero, zero), J[..., :D], J[..., D:]


def _edge_args(g, R, t):
    return R[g.i], t[g.i], R[g.j], t[g.j], g.Rm, g.tm


def _sim3_edge_args(g, R, t, s):
    return (R[g.i], t[g.i], s[g.i], R[g.j], t[g.j], s[g.j], g.Rm, g.tm,
            g.sm)


def _weighted_cost(g, r):
    w = g.weight * g.edge_valid
    return (w * (r * r).sum(-1)).sum()


def pose_graph_cost(g: PoseGraph, R, t) -> torch.Tensor:
    a = _edge_args(g, R, t)
    zero = R.new_zeros(g.i.shape[0], 6)
    return _weighted_cost(g, _edge_residual(zero, zero, *a))


def sim3_graph_cost(g: Sim3Graph, R, t, s) -> torch.Tensor:
    a = _sim3_edge_args(g, R, t, s)
    zero = R.new_zeros(g.i.shape[0], 7)
    return _weighted_cost(g, _sim3_edge_residual(zero, zero, *a))


# ---------------------------------------------------------------------------
# normal equations
# ---------------------------------------------------------------------------


class GraphPlans(NamedTuple):
    """The segment-sum plans of one graph's edge ends."""

    i: SegmentPlan                  # source node over N
    j: SegmentPlan                  # target node over N
    pairs: tuple | None             # the dense solve's (i,i), (i,j), (j,i),
    #                                 (j,j) block indices over N * N


def graph_plans(i: torch.Tensor, j: torch.Tensor, N: int,
                dense: bool) -> GraphPlans:
    """Plans of the edge ends (and, for the dense solve, of the four block
    indices), on the indices' device: built once per optimize call."""
    pairs = None
    if dense:
        pairs = tuple(segment_plan(pr, N * N) for pr in
                      (i * N + i, i * N + j, j * N + i, j * N + j))
    return GraphPlans(segment_plan(i, N), segment_plan(j, N), pairs)


def _solve_graph_system(r, Ji, Jj, i, j, weight, frozen, lam, N: int, D: int,
                        solver: str, cg_iters: int, plans: GraphPlans):
    """Solve the damped GN normal equations of an edge graph.

    r [E, D]; Ji/Jj [E, D, D]; i/j [E] node ids; weight [E] (0 for invalid
    edges); frozen [N] gauge/invalid mask; plans: graph_plans(i, j, N,
    solver == "dense"). Returns dx [N, D]."""
    w = weight[:, None, None]
    Jiw = Ji * w
    Jjw = Jj * w
    b = (-segment_sum(torch.einsum("eai,ea->ei", Jiw, r), plans.i)
         - segment_sum(torch.einsum("eai,ea->ei", Jjw, r), plans.j))
    free = (~frozen).to(r.dtype)
    b = b * free[:, None]
    eyeD = torch.eye(D, dtype=r.dtype, device=r.device)

    if solver == "dense":
        blocks = (torch.einsum("eai,eaj->eij", Jiw, Ji),
                  torch.einsum("eai,eaj->eij", Jiw, Jj),
                  torch.einsum("eai,eaj->eij", Jjw, Ji),
                  torch.einsum("eai,eaj->eij", Jjw, Jj))
        H = r.new_zeros((N * N, D, D))
        for blk, pr in zip(blocks, plans.pairs):
            H = H + segment_sum(blk, pr)
        H = H.reshape(N, N, D, D).permute(0, 2, 1, 3).reshape(N * D, N * D)
        m = free.repeat_interleave(D)
        H = H * m[:, None] * m[None, :] + torch.diag(1.0 - m)
        H = H + lam * torch.eye(N * D, dtype=r.dtype, device=r.device)
        # a singular system gives NaN, as jnp.linalg.solve gives a
        # non-finite result; the LM accept rejects it
        x, info = torch.linalg.solve_ex(H, b.reshape(-1) * m,
                                        check_errors=False)
        x = torch.where(info == 0, x, torch.full_like(x, float("nan")))
        return x.reshape(N, D)
    if solver != "cg":
        raise ValueError(f"unknown pose-graph solver {solver!r}")

    # ---- matrix-free CG ----
    def matvec(v):                     # v [N, D]
        vf = v * free[:, None]         # zero frozen columns
        yi = (torch.einsum("eab,eb->ea", Ji, vf[i])
              + torch.einsum("eab,eb->ea", Jj, vf[j]))   # J v per edge
        out = (segment_sum(torch.einsum("eai,ea->ei", Jiw, yi), plans.i)
               + segment_sum(torch.einsum("eai,ea->ei", Jjw, yi), plans.j))
        out = out * free[:, None] + v * (1.0 - free[:, None])
        return out + lam * vf

    # block-Jacobi preconditioner: per-node D x D diagonal blocks
    Hii = (segment_sum(torch.einsum("eai,eaj->eij", Jiw, Ji), plans.i)
           + segment_sum(torch.einsum("eai,eaj->eij", Jjw, Jj), plans.j))
    Hii = Hii + (lam + 1e-8) * eyeD
    Hii = Hii * free[:, None, None] + eyeD * (1.0 - free[:, None, None])
    # inv_ex: no status check on the host (torch.linalg.inv waits for it)
    Hii_inv = torch.linalg.inv_ex(Hii, check_errors=False)[0]

    def precond(v):
        return torch.einsum("nij,nj->ni", Hii_inv, v)

    x = torch.zeros_like(b)
    rr = b
    p = precond(rr)
    rz = (rr * p).sum()
    for _ in range(cg_iters):          # no early exit, as the reference
        q = matvec(p)
        alpha = rz / (p * q).sum().clamp_min(1e-20)
        x = x + alpha * p
        rr = rr - alpha * q
        z = precond(rr)
        rz2 = (rr * z).sum()
        p = z + rz2 / rz.clamp_min(1e-20) * p
        rz = rz2
    return x * free[:, None]


def resolve_solver(cfg: PoseGraphConfig, n_nodes: int) -> str:
    if cfg.solver == "auto":
        return "dense" if n_nodes <= cfg.cg_threshold else "cg"
    return cfg.solver


def _frozen(node_valid: torch.Tensor) -> torch.Tensor:
    return ~node_valid | (torch.arange(node_valid.shape[0],
                                       device=node_valid.device) == 0)


# ---------------------------------------------------------------------------
# SE(3) graph
# ---------------------------------------------------------------------------


def _gn_step(g: PoseGraph, R, t, lam, solver: str, cg_iters: int,
             plans: GraphPlans):
    N = R.shape[0]
    r, Ji, Jj = _with_jacobians(_edge_residual, 6, *_edge_args(g, R, t))
    dx = _solve_graph_system(r, Ji, Jj, g.i, g.j, g.weight * g.edge_valid,
                             _frozen(g.node_valid), lam, N, 6, solver,
                             cg_iters, plans)
    dR, dt = se3.se3_exp(dx)
    return dR @ R, (dR @ t[..., None])[..., 0] + dt


def _lm_update(acc, lam):
    return torch.clamp(torch.where(acc, lam * 0.5, lam * 4.0), 1e-9, 1e4)


def optimize_pose_graph(g: PoseGraph, cfg: PoseGraphConfig) -> PoseGraphResult:
    """LM-damped GN on the SE(3) graph: cfg.iters steps, masked accept."""
    f32_matmul()
    R, t = g.R, g.t
    solver = resolve_solver(cfg, R.shape[0])
    plans = graph_plans(g.i, g.j, R.shape[0], solver == "dense")
    lam = torch.full((), cfg.damping, dtype=R.dtype, device=R.device)
    cost = init = pose_graph_cost(g, R, t)
    for _ in range(cfg.iters):
        Rn, tn = _gn_step(g, R, t, lam, solver, cfg.cg_iters, plans)
        cn = pose_graph_cost(g, Rn, tn)
        acc = cn < cost
        R = torch.where(acc, Rn, R)
        t = torch.where(acc, tn, t)
        cost = torch.where(acc, cn, cost)
        lam = _lm_update(acc, lam)
    return PoseGraphResult(R=R, t=t, cost=cost, initial_cost=init)


# ---------------------------------------------------------------------------
# Sim(3) graph: 7-DoF corrections for monocular scale drift, node 0 frozen
# as the 7-DoF gauge (global pose AND scale)
# ---------------------------------------------------------------------------


def _sim3_gn_step(g: Sim3Graph, R, t, s, lam, solver: str, cg_iters: int,
                  plans: GraphPlans):
    N = R.shape[0]
    r, Ji, Jj = _with_jacobians(_sim3_edge_residual, 7,
                                *_sim3_edge_args(g, R, t, s))
    dx = _solve_graph_system(r, Ji, Jj, g.i, g.j, g.weight * g.edge_valid,
                             _frozen(g.node_valid), lam, N, 7, solver,
                             cg_iters, plans)
    return sim3.compose(*sim3.sim3_exp(dx), R, t, s)


def optimize_sim3_graph(g: Sim3Graph, cfg: PoseGraphConfig) -> Sim3GraphResult:
    """LM-damped GN on the Sim(3) graph: cfg.iters steps, masked accept."""
    f32_matmul()
    R, t, s = g.R, g.t, g.s
    solver = resolve_solver(cfg, R.shape[0])
    plans = graph_plans(g.i, g.j, R.shape[0], solver == "dense")
    lam = torch.full((), cfg.damping, dtype=R.dtype, device=R.device)
    cost = init = sim3_graph_cost(g, R, t, s)
    for _ in range(cfg.iters):
        Rn, tn, sn = _sim3_gn_step(g, R, t, s, lam, solver, cfg.cg_iters,
                                   plans)
        cn = sim3_graph_cost(g, Rn, tn, sn)
        acc = cn < cost
        R = torch.where(acc, Rn, R)
        t = torch.where(acc, tn, t)
        s = torch.where(acc, sn, s)
        cost = torch.where(acc, cn, cost)
        lam = _lm_update(acc, lam)
    return Sim3GraphResult(R=R, t=t, s=s, cost=cost, initial_cost=init)

"""Trajectory-sharded bundle adjustment: the keyframe axis is partitioned
across the mesh (visualslam_tpu/parallel/traj_ba.py).

Parallel decomposition (vs parallel/dist_ba.py, which replicates cameras):

  - cameras are sharded in contiguous trajectory blocks: shard s owns
    keyframes [s*Cs, (s+1)*Cs), since covisibility is temporally local;
  - landmarks go to the shard that owns MOST of their observations
    (host-side majority partition with spill); observations live with
    their landmark's shard;
  - the camera blocks every shard needs are ring all-gathered;
  - dense step: each shard assembles the reduced-system rows its
    landmarks touch, and a ring REDUCE-SCATTER over camera blocks folds
    them into the owning shard, [Cs, 6, C, 6] per shard; the system is
    solved by block-row Jacobi CG (`_distributed_cg`): the search
    direction is all-gathered per matvec, inner products psum'd;
  - matrix-free step (cfg.solver == "schur_mf"): U [C, 6, 6] and the
    right-hand side are psum'd and replicated, and the observation-coupled
    term W V^-1 W^T v is computed from local observations and psum'd once
    per CG matvec; neither the coupling nor Schur rows materialize;
  - back-substitution is landmark-local.

The shards run one after another in one Python loop (parallel/mesh.py).
Every loop has a fixed trip count and freezes with `torch.where`, so
nothing is read on the host inside the LM or CG loops, and on one card
the LM loop replays captured graphs (parallel/programs.py).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualslam_tpu_torch.backend.ba import (
    BAProblem,
    BAResult,
    _inv3x3,
    ba_plans,
    backsub_landmarks,
    backsub_landmarks_mf,
    normal_equations,
    normal_equations_mf,
    robust_cost,
    schur_camera_system,
)
from visualslam_tpu_torch.geometry import se3
from visualslam_tpu_torch.ops.cuda.segment import segment_sum
from visualslam_tpu_torch.parallel import collectives as col
from visualslam_tpu_torch.parallel.dist_ba import _np, lm_update
from visualslam_tpu_torch.parallel.mesh import Mesh, axis_devices
from visualslam_tpu_torch.parallel.programs import (
    MeshKey,
    MeshLoopProgram,
    mesh_input,
)
from visualslam_tpu_torch.utils.config import BAConfig
from visualslam_tpu_torch.utils.precision import f32_matmul


class TrajShardedBAProblem(NamedTuple):
    """Leading axis = shard (n). Shapes:
    R [n, Cs, 3, 3], t [n, Cs, 3], cam_valid [n, Cs]   (camera blocks);
    X [n, Ls, 3], lm_valid [n, Ls]                      (landmark shards);
    cam_idx [n, Os] GLOBAL camera ids, lm_idx [n, Os] LOCAL landmark ids,
    uv [n, Os, 2], obs_valid [n, Os];
    lm_order [n*Ls] host-side: original landmark id of packed slot, -1 for
    an empty slot (use with unshard_traj)."""

    R: torch.Tensor
    t: torch.Tensor
    cam_valid: torch.Tensor
    X: torch.Tensor
    lm_valid: torch.Tensor
    cam_idx: torch.Tensor
    lm_idx: torch.Tensor
    uv: torch.Tensor
    obs_valid: torch.Tensor
    lm_order: np.ndarray


def pad_cameras(p: BAProblem, n: int) -> BAProblem:
    """Pad the camera axis to a multiple of n with invalid identity
    cameras (the camera-block split of shard_problem_trajectory)."""
    extra = -p.R.shape[0] % n
    if not extra:
        return p
    dev = p.R.device
    return p._replace(
        R=torch.cat([p.R, torch.eye(3, dtype=p.R.dtype, device=dev).expand(
            extra, 3, 3)]),
        t=torch.cat([p.t, p.t.new_zeros(extra, 3)]),
        cam_valid=torch.cat([p.cam_valid, p.cam_valid.new_zeros(extra)]))


def shard_problem_trajectory(p: BAProblem,
                             n_shards: int) -> TrajShardedBAProblem:
    """Host-side covisibility-aware partition, as tensors on p's device.
    Requires C % n_shards == 0.

    Landmarks are assigned to the shard owning the majority of their
    observations; shards over capacity spill to the least-loaded shard
    (those landmarks simply ride the boundary exchange)."""
    C = p.R.shape[0]
    L = p.X.shape[0]
    assert C % n_shards == 0, f"C={C} not divisible by {n_shards}"
    Cs = C // n_shards
    Ls = -(-L // n_shards)          # ceil

    cam = _np(p.cam_idx)
    lm = _np(p.lm_idx)
    ov = _np(p.obs_valid)
    shard_of_cam = cam // Cs

    # majority vote per landmark
    votes = np.zeros((L, n_shards), np.int64)
    np.add.at(votes, (lm[ov], shard_of_cam[ov]), 1)
    want = np.argmax(votes, axis=1)
    # unobserved landmarks: spread round-robin (they are inert)
    unobserved = votes.sum(1) == 0
    want[unobserved] = np.arange(L)[unobserved] % n_shards

    # capacity-constrained assignment with spill
    fill = np.zeros(n_shards, np.int64)
    assign = np.empty(L, np.int64)
    spill = []
    for li in np.argsort(-votes.max(1), kind="stable"):  # strongest first
        s = want[li]
        if fill[s] < Ls:
            assign[li] = s
            fill[s] += 1
        else:
            spill.append(li)
    for li in spill:
        s = int(np.argmin(fill))
        assign[li] = s
        fill[s] += 1

    # pack: slot s*Ls + k  <-  k-th landmark assigned to shard s
    lm_order = np.full(n_shards * Ls, -1, np.int64)
    slot_of = np.empty(L, np.int64)
    cursor = np.zeros(n_shards, np.int64)
    for li in range(L):
        s = assign[li]
        slot = s * Ls + cursor[s]
        slot_of[li] = slot
        lm_order[slot] = li
        cursor[s] += 1

    lm_slot = slot_of[lm]
    shard_of_obs = lm_slot // Ls
    per = [np.nonzero((shard_of_obs == s) & ov)[0] for s in range(n_shards)]
    Os = max(max(len(x) for x in per), 1)

    def pad_gather(arr, fill=0):
        out = np.full((n_shards, Os) + arr.shape[1:], fill, arr.dtype)
        for s, sel in enumerate(per):
            out[s, : len(sel)] = arr[sel]
        return out

    valid = np.zeros((n_shards, Os), bool)
    for s, sel in enumerate(per):
        valid[s, : len(sel)] = True

    X_np = np.zeros((n_shards * Ls, 3), np.float32)
    lmv_np = np.zeros(n_shards * Ls, bool)
    filled = lm_order >= 0
    X_np[filled] = _np(p.X)[lm_order[filled]]
    lmv_np[filled] = _np(p.lm_valid)[lm_order[filled]]

    dev = p.X.device

    def T(x):
        return torch.as_tensor(x, device=dev)

    return TrajShardedBAProblem(
        R=T(_np(p.R).reshape(n_shards, Cs, 3, 3)),
        t=T(_np(p.t).reshape(n_shards, Cs, 3)),
        cam_valid=T(_np(p.cam_valid).reshape(n_shards, Cs)),
        X=T(X_np.reshape(n_shards, Ls, 3)),
        lm_valid=T(lmv_np.reshape(n_shards, Ls)),
        cam_idx=T(pad_gather(cam).astype(np.int32)),
        lm_idx=T((pad_gather(lm_slot) % Ls).astype(np.int32)),
        uv=T(pad_gather(_np(p.uv))),
        obs_valid=T(valid),
        lm_order=lm_order,
    )


def unshard_traj(R_s, t_s, X_s, lm_order: np.ndarray, L: int):
    """Undo the shard packing (numpy out): camera blocks [n, Cs, ...] ->
    [C, ...]; landmarks [n, Ls, 3] -> [L, 3] in original order."""
    R = _np(R_s).reshape(-1, 3, 3)
    t = _np(t_s).reshape(-1, 3)
    Xp = _np(X_s).reshape(-1, 3)
    X = np.zeros((L, 3), np.float32)
    filled = lm_order >= 0
    X[lm_order[filled]] = Xp[filled]
    return R, t, X


def _distributed_cg(S_rows, b_rows, frozen_rows, lam, cg_iters: int):
    """Jacobi-preconditioned CG on the reduced camera system with block-row
    sharding; every argument is a list with one entry per shard. S_rows:
    [Cs, 6, C, 6] a shard's rows; b_rows: [Cs, 6]; frozen_rows: [Cs*6]
    bool (gauge + invalid cameras, LOCAL rows); lam: 0-d. Returns dc for
    each shard's block [Cs, 6]."""
    n = len(S_rows)
    Cs = S_rows[0].shape[0]
    C = S_rows[0].shape[2]
    # global frozen mask: columns of frozen rows are zeroed too
    frozen_all = col.ring_all_gather(frozen_rows)
    A, b, inv_diag = [], [], []
    for s in range(n):
        dev = S_rows[s].device
        A_s = S_rows[s].reshape(Cs * 6, C * 6)
        free_all = (~frozen_all[s].reshape(C * 6)).to(A_s.dtype)
        free_loc = free_all[s * Cs * 6:(s + 1) * Cs * 6]
        A_s = A_s * free_loc[:, None] * free_all[None, :]
        # damping + identity on frozen local rows
        ar = torch.arange(Cs * 6, device=dev)
        rows = s * Cs * 6 + ar
        A_s[ar, rows] += lam[s] * free_loc + (1.0 - free_loc)
        A.append(A_s)
        b.append(b_rows[s].reshape(Cs * 6) * free_loc)
        inv_diag.append(1.0 / torch.clamp_min(A_s[ar, rows], 1e-12))

    x = [torch.zeros_like(v) for v in b]
    r = b
    z = [d * v for d, v in zip(inv_diag, r)]
    p = z
    rz = col.psum([torch.dot(a, c) for a, c in zip(r, z)])
    for _ in range(cg_iters):
        p_full = col.ring_all_gather(p)
        q = [A[s] @ p_full[s].reshape(C * 6) for s in range(n)]
        pq = col.psum([torch.dot(a, c) for a, c in zip(p, q)])
        alpha = [a / torch.clamp_min(c, 1e-20) for a, c in zip(rz, pq)]
        x = [v + a * w for v, a, w in zip(x, alpha, p)]
        r = [v - a * w for v, a, w in zip(r, alpha, q)]
        z = [d * v for d, v in zip(inv_diag, r)]
        rz2 = col.psum([torch.dot(a, c) for a, c in zip(r, z)])
        beta = [a / torch.clamp_min(c, 1e-20) for a, c in zip(rz2, rz)]
        p = [v + bt * w for v, bt, w in zip(z, beta, p)]
        rz = rz2
    return [v.reshape(Cs, 6) for v in x]


def _step_mf(shards, R_all, t_all, X, lam, cv_all, Cs: int, cfg: BAConfig,
             plans):
    """Matrix-free distributed step: U [C, 6, 6] and the right-hand side
    psum'd and replicated, one [C, 6] psum per CG matvec; the CG state is
    replicated (every shard runs it on equal values). `plans`: each
    shard's BAPlans. Returns each shard's (dc_blk [Cs, 6], dl [Ls, 3])."""
    n = len(shards)
    C = R_all[0].shape[0]
    parts = [normal_equations_mf(p, R_all[s], t_all[s], X[s], cfg, plans[s])
             for s, p in enumerate(shards)]
    U_all = col.psum([pt[0] for pt in parts])              # [C, 6, 6]
    V_inv, wyb_p = [], []
    for s, (p, (U_p, V, bc_p, bl, Wo)) in enumerate(zip(shards, parts)):
        eye3 = torch.eye(3, dtype=V.dtype, device=V.device)
        Vi = _inv3x3(V + lam[s] * eye3)                    # local landmarks
        ybl = torch.einsum("lij,lj->li", Vi, bl)
        wyb = segment_sum(torch.einsum("oij,oj->oi", Wo, ybl[p.lm_idx]),
                          plans[s].cam)
        V_inv.append(Vi)
        wyb_p.append(bc_p - wyb)
    b_all = col.psum(wyb_p)                                # [C, 6]

    free6, inv_diag = [], []
    for s in range(n):
        dev = U_all[s].device
        frozen = ~cv_all[s]
        if cfg.fix_first_camera:
            frozen = frozen | (torch.arange(C, device=dev) == 0)
        f6 = (~frozen).to(U_all[s].dtype)[:, None].expand(C, 6)
        free6.append(f6)
        b_all[s] = b_all[s] * f6
        # Jacobi preconditioner from U's diagonal
        diagU = torch.diagonal(U_all[s], dim1=-2, dim2=-1) + lam[s]
        inv_diag.append(f6 / torch.clamp_min(diagU, 1e-12) + (1.0 - f6))

    def mv(v):
        partial = []
        for s, (p, pt) in enumerate(zip(shards, parts)):
            Wo = pt[4]
            vm = v[s] * free6[s]
            a = torch.einsum("oij,oi->oj", Wo, vm[p.cam_idx])
            q = segment_sum(a, plans[s].lm)
            y = torch.einsum("lij,lj->li", V_inv[s], q)
            bo = torch.einsum("oij,oj->oi", Wo, y[p.lm_idx])
            partial.append(segment_sum(bo, plans[s].cam))
        ssum = col.psum(partial)
        out = []
        for s in range(n):
            vm = v[s] * free6[s]
            Sv = (torch.einsum("cij,cj->ci", U_all[s], vm) + lam[s] * vm
                  - ssum[s])
            out.append(Sv * free6[s] + v[s] * (1.0 - free6[s]))
        return out

    x = [torch.zeros_like(v) for v in b_all]
    r = b_all
    z = [d * v for d, v in zip(inv_diag, r)]
    pvec = z
    rz = [(a * c).sum() for a, c in zip(r, z)]
    for _ in range(cfg.cg_iters):
        q = mv(pvec)
        new = []
        for s in range(n):
            pq = (pvec[s] * q[s]).sum()
            alpha = rz[s] / torch.clamp_min(pq, 1e-20)
            x2 = x[s] + alpha * pvec[s]
            r2 = r[s] - alpha * q[s]
            z2 = inv_diag[s] * r2
            rz2 = (r2 * z2).sum()
            beta = rz2 / torch.clamp_min(rz[s], 1e-20)
            new.append((x2, r2, z2 + beta * pvec[s], rz2))
        x, r, pvec, rz = (list(v) for v in zip(*new))
    out = []
    for s, (p, pt) in enumerate(zip(shards, parts)):
        dc_all = x[s] * free6[s]                           # replicated
        dl = backsub_landmarks_mf(p, V_inv[s], pt[3], pt[4], dc_all,
                                  p.lm_valid, plans[s])
        out.append((dc_all[s * Cs:(s + 1) * Cs], dl))
    return out


def _step_dense(shards, R_all, t_all, X, lam, cv_blk, Cs: int,
                cfg: BAConfig, plans):
    """Dense distributed step: ring reduce-scatter of the [Cs, 6, C, 6]
    Schur rows, then block-row Jacobi CG. `plans`: each shard's BAPlans.
    Returns each shard's (dc_blk [Cs, 6], dl [Ls, 3])."""
    n = len(shards)
    C = R_all[0].shape[0]
    S, b, V_inv, bl, Wd = [], [], [], [], []
    for s, p in enumerate(shards):
        U, V, bc, bl_s, Wd_s = normal_equations(p, R_all[s], t_all[s], X[s],
                                                cfg, plans[s])
        S_s, b_s, Vi = schur_camera_system(U, V, bc, bl_s, Wd_s, lam[s])
        S.append(S_s.reshape(n, Cs, 6, C, 6))
        b.append(b_s.reshape(n, Cs, 6))
        V_inv.append(Vi)
        bl.append(bl_s)
        Wd.append(Wd_s)
    # boundary exchange: fold each shard's contributions to REMOTE camera
    # rows into their owners
    S_rows = col.ring_reduce_scatter(S)                    # [Cs, 6, C, 6]
    b_rows = col.ring_reduce_scatter(b)                    # [Cs, 6]
    frozen_rows = []
    for s in range(n):
        frozen = ~cv_blk[s]
        if cfg.fix_first_camera:
            glob = s * Cs + torch.arange(Cs, device=frozen.device)
            frozen = frozen | (glob == 0)
        # repeat each flag 6 times (an expand: repeat_interleave sizes its
        # output on the host)
        frozen_rows.append(frozen[:, None].expand(Cs, 6).reshape(-1))
    dc_blk = _distributed_cg(S_rows, b_rows, frozen_rows, lam, cfg.cg_iters)
    dc_all = col.ring_all_gather(dc_blk)
    return [(dc_blk[s], backsub_landmarks(V_inv[s], bl[s], Wd[s],
                                          dc_all[s].reshape(C, 6),
                                          p.lm_valid))
            for s, p in enumerate(shards)]


def _gather_poses(R_blk, t_blk, C: int):
    """Every shard's camera blocks ring all-gathered: [C, 3, 3] and
    [C, 3] on every shard."""
    R_all = [v.reshape(C, 3, 3) for v in col.ring_all_gather(R_blk)]
    t_all = [v.reshape(C, 3) for v in col.ring_all_gather(t_blk)]
    return R_all, t_all


def _cost_of(shards, cfg: BAConfig, C: int, R_blk, t_blk, X) -> list:
    """The psum'd robust cost of the sharded state, replicated."""
    R_all, t_all = _gather_poses(R_blk, t_blk, C)
    return col.psum([robust_cost(p, R_all[s], t_all[s], X[s],
                                 cfg.huber_delta)
                     for s, p in enumerate(shards)])


def _traj_enter(x: tuple, key: MeshKey):
    """(aux, carry) of the trajectory-sharded LM loop: each shard's
    problem views (over the ring all-gathered camera validity), plans,
    validity blocks and the psum'd initial cost; the per-shard camera
    blocks, landmarks, damping and cost, a tuple of per-shard tuples
    each."""
    sp = TrajShardedBAProblem(*x, lm_order=None)
    cfg, devs = key.cfg, key.devices
    n = len(devs)
    C = n * sp.R.shape[1]
    R_blk = [sp.R[s].to(d) for s, d in enumerate(devs)]
    t_blk = [sp.t[s].to(d) for s, d in enumerate(devs)]
    cv_blk = [sp.cam_valid[s].to(d) for s, d in enumerate(devs)]
    X = [sp.X[s].to(d) for s, d in enumerate(devs)]
    cv_all = [v.reshape(C) for v in col.ring_all_gather(cv_blk)]
    shards = [BAProblem(
        R=None, t=None, X=None, cam_idx=sp.cam_idx[s].to(d),
        lm_idx=sp.lm_idx[s].to(d), uv=sp.uv[s].to(d),
        obs_valid=sp.obs_valid[s].to(d), cam_valid=cv_all[s],
        lm_valid=sp.lm_valid[s].to(d)) for s, d in enumerate(devs)]
    # one set of segment-sum plans per shard, built once
    plans = [ba_plans(p.cam_idx, p.lm_idx, C, X[s].shape[0],
                      cfg.solver != "schur_mf")
             for s, p in enumerate(shards)]
    lam = [torch.full((), cfg.damping_init, dtype=v.dtype, device=v.device)
           for v in X]
    cost = _cost_of(shards, cfg, C, R_blk, t_blk, X)
    return (shards, plans, cv_all, cv_blk, cost[0]), tuple(
        tuple(v) for v in (R_blk, t_blk, X, lam, cost))


def _traj_step(x: tuple, key: MeshKey, aux, carry) -> tuple:
    """One LM iteration: the poses gathered, a matrix-free or dense
    distributed step, the SE(3) update, the psum'd cost and each shard's
    accept."""
    shards, plans, cv_all, cv_blk, _ = aux
    cfg = key.cfg
    R_blk, t_blk, X, lam, cost = (list(v) for v in carry)
    Cs = R_blk[0].shape[0]
    C = len(shards) * Cs
    R_all, t_all = _gather_poses(R_blk, t_blk, C)
    if cfg.solver == "schur_mf":
        steps = _step_mf(shards, R_all, t_all, X, lam, cv_all, Cs, cfg,
                         plans)
    else:
        steps = _step_dense(shards, R_all, t_all, X, lam, cv_blk, Cs, cfg,
                            plans)
    Rn, tn, Xn = [], [], []
    for s, (dc_blk, dl) in enumerate(steps):
        dR, dt = se3.se3_exp(dc_blk)
        Rn.append(dR @ R_blk[s])
        tn.append((dR @ t_blk[s][..., None])[..., 0] + dt)
        Xn.append(X[s] + dl)
    new_cost = _cost_of(shards, cfg, C, Rn, tn, Xn)
    for s in range(len(shards)):
        (R_blk[s], t_blk[s], X[s]), cost[s], lam[s] = lm_update(
            cfg, new_cost[s], cost[s], lam[s], (Rn[s], tn[s], Xn[s]),
            (R_blk[s], t_blk[s], X[s]))
    return tuple(tuple(v) for v in (R_blk, t_blk, X, lam, cost))


def _traj_result(x: tuple, key: MeshKey, aux, carry) -> BAResult:
    """The per-shard stacks and the first shard's cost and damping, on
    the first shard's device."""
    R_blk, t_blk, X, lam, cost = carry
    d0 = key.devices[0]

    def stack(vs):
        return torch.stack([v.to(d0) for v in vs])

    return BAResult(R=stack(R_blk), t=stack(t_blk), X=stack(X),
                    cost=cost[0], initial_cost=aux[4], lm_lambda=lam[0])


def _run_ba_traj_sharded(x: tuple, key: MeshKey) -> BAResult:
    """The eager trajectory-sharded LM loop: enter, key.cfg.iters steps,
    result (what the graphs replay)."""
    f32_matmul()
    aux, carry = _traj_enter(x, key)
    for _ in range(key.cfg.iters):
        carry = _traj_step(x, key, aux, carry)
    return _traj_result(x, key, aux, carry)


_RUN_BA_TRAJ_SHARDED = MeshLoopProgram(_run_ba_traj_sharded, _traj_enter,
                                       _traj_step, _traj_result)


def traj_ba_args(sp: TrajShardedBAProblem, cfg: BAConfig, mesh: Mesh,
                 axis: str = "shard") -> tuple:
    """run_ba_traj_sharded's program arguments (x, MeshKey): the problem's
    tensors (lm_order, host-side, stays out) and the static key."""
    devs = axis_devices(mesh, axis)
    return mesh_input(tuple(sp)[:-1], devs), MeshKey(cfg, devs, axis)


def run_ba_traj_sharded(sp: TrajShardedBAProblem, cfg: BAConfig,
                        mesh: Mesh, axis: str = "shard") -> BAResult:
    """Distributed LM loop over the trajectory-sharded problem, at float32
    product precision (TF32 off). Returns BAResult with R/t/X still stacked
    per shard (use unshard_traj), on the first shard's device.

    On a mesh whose shards are all one CUDA device the loop replays
    captured graphs per shape key and (cfg, devices, axis)
    (parallel/programs.MeshLoopProgram; the JAX package's jitted
    shard_map); on the CPU and over several devices it runs eagerly.
    The results are the caller's."""
    return _RUN_BA_TRAJ_SHARDED(*traj_ba_args(sp, cfg, mesh, axis))


run_ba_traj_sharded.program = _RUN_BA_TRAJ_SHARDED

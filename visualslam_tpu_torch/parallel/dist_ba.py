"""Distributed bundle adjustment: landmark / observation sharding with an
all-reduced Schur system (visualslam_tpu/parallel/dist_ba.py).

Parallel decomposition:
  - camera poses are tiny (C <= ~10) and REPLICATED on every shard;
  - landmarks and their observations are SHARDED over the mesh axis (each
    observation lives with its landmark's shard, so V blocks and landmark
    updates are local);
  - each shard assembles its partial reduced camera system
    S_s = U_s - W_s V_s^-1 W_s^T and b_s; one all-reduce gives the global
    6C x 6C system, the only communication per LM iteration;
  - every shard solves the same small system, applies identical pose
    updates and back-substitutes its own landmarks.

LM accept / reject uses the psum'd global cost, so every shard takes the
same decision. The shards run one after another in one Python loop
(parallel/mesh.py); nothing is read on the host inside the LM loop.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualslam_tpu_torch.backend.ba import (
    BAProblem,
    BAResult,
    apply_increments,
    ba_plans,
    backsub_landmarks,
    normal_equations,
    robust_cost,
    schur_camera_system,
    solve_cameras,
)
from visualslam_tpu_torch.parallel import collectives as col
from visualslam_tpu_torch.parallel.mesh import Mesh, axis_devices
from visualslam_tpu_torch.utils.config import BAConfig
from visualslam_tpu_torch.utils.precision import f32_matmul


class ShardedBAProblem(NamedTuple):
    """Leading axis = shard. Shapes:
    R [C,3,3], t [C,3], cam_valid [C] (replicated);
    X [n, L_s, 3], lm_valid [n, L_s];
    cam_idx/lm_idx/uv/obs_valid [n, O_s] (lm_idx LOCAL to the shard);
    lm_order [L] host-side: original landmark index of each packed slot
    (identity for the block partition) — use with unshard_points."""

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


def _np(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def lm_update(cfg: BAConfig, new_cost, cost, lam, proposed, current):
    """One shard's LM accept / reject on the psum'd costs: the proposed
    state where the cost fell, lambda down on accept and up on reject.
    Returns (state, cost, lam)."""
    acc = new_cost < cost
    state = tuple(torch.where(acc, p, c) for p, c in zip(proposed, current))
    lam = torch.clamp(torch.where(acc, lam * cfg.damping_down,
                                  lam * cfg.damping_up), 1e-9, 1e6)
    return state, torch.where(acc, new_cost, cost), lam


def _partition_landmarks(p: BAProblem, n_shards: int, Ls: int,
                         partition: str) -> np.ndarray:
    """Returns lm_order [L]: original landmark index for each packed slot
    (slot s*Ls + k lives on shard s)."""
    L = p.X.shape[0]
    if partition == "block":
        return np.arange(L)
    if partition != "balanced":
        raise ValueError(f"unknown partition {partition!r}")

    # Balanced partition: the padded O_s = max_s count makes every shard
    # pay for the heaviest one. Greedy LPT bin-packing of landmarks by
    # their observation count (heaviest first, onto the lightest non-full
    # shard) keeps loads near-equal. Cameras are replicated, so the
    # partition affects load balance only, never communication.
    lm = _np(p.lm_idx)
    ov = _np(p.obs_valid)
    counts = np.bincount(lm[ov], minlength=L)
    order = np.argsort(-counts, kind="stable")
    load = np.zeros(n_shards, np.int64)
    fill = np.zeros(n_shards, np.int64)
    slots = np.empty(L, np.int64)
    for li in order:
        open_shards = np.nonzero(fill < Ls)[0]
        s = open_shards[np.argmin(load[open_shards])]
        slots[li] = s * Ls + fill[s]
        load[s] += counts[li]
        fill[s] += 1
    lm_order = np.empty(L, np.int64)
    lm_order[slots] = np.arange(L)
    return lm_order


def shard_problem(p: BAProblem, n_shards: int,
                  partition: str = "balanced") -> ShardedBAProblem:
    """Host-side partition of a BAProblem into n landmark shards, as
    tensors on p's device.

    Observations follow their landmark and are padded to the max per-shard
    count. partition: "balanced" (default; greedy observation-load
    balancing, see _partition_landmarks) or "block" (index blocks).
    Requires L % n_shards == 0."""
    L = p.X.shape[0]
    assert L % n_shards == 0, f"L={L} not divisible by {n_shards}"
    Ls = L // n_shards
    lm_order = _partition_landmarks(p, n_shards, Ls, partition)
    slot_of = np.empty(L, np.int64)      # original lm index -> packed slot
    slot_of[lm_order] = np.arange(L)

    lm = _np(p.lm_idx)
    ov = _np(p.obs_valid)
    lm_slot = slot_of[lm]
    shard_of = lm_slot // Ls

    per = [np.nonzero((shard_of == s) & ov)[0] for s in range(n_shards)]
    O_s = max(max(len(s) for s in per), 1)

    def pad_gather(arr, fill=0):
        out = np.full((n_shards, O_s) + arr.shape[1:], fill, arr.dtype)
        for s, sel in enumerate(per):
            out[s, : len(sel)] = arr[sel]
        return out

    valid = np.zeros((n_shards, O_s), bool)
    for s, sel in enumerate(per):
        valid[s, : len(sel)] = True

    dev = p.X.device

    def T(x):
        return torch.as_tensor(x, device=dev)

    X_np = _np(p.X)[lm_order]
    lmv_np = _np(p.lm_valid)[lm_order]
    return ShardedBAProblem(
        R=p.R, t=p.t, cam_valid=p.cam_valid,
        X=T(X_np.reshape(n_shards, Ls, 3)),
        lm_valid=T(lmv_np.reshape(n_shards, Ls)),
        cam_idx=T(pad_gather(_np(p.cam_idx))),
        lm_idx=T((pad_gather(lm_slot) % Ls).astype(np.int32)),
        uv=T(pad_gather(_np(p.uv))),
        obs_valid=T(valid),
        lm_order=lm_order,
    )


def unshard_points(X_sharded: torch.Tensor,
                   lm_order: np.ndarray | None = None) -> torch.Tensor:
    """Inverse of the shard packing: [n, L_s, 3] -> [L, 3] in the ORIGINAL
    landmark order (pass sp.lm_order for non-block partitions)."""
    X = X_sharded.reshape(-1, 3)
    if lm_order is None:
        return X
    inv = np.empty(len(lm_order), np.int64)
    inv[lm_order] = np.arange(len(lm_order))
    return X[torch.as_tensor(inv, device=X.device)]


def run_ba_sharded(sp: ShardedBAProblem, cfg: BAConfig, mesh: Mesh,
                   axis: str = "shard", reduce: str = "psum") -> BAResult:
    """Distributed LM loop over the mesh's shards. Returns BAResult with X
    stacked [n, L_s, 3] (use unshard_points) and the replicated values, all
    on the first shard's device.

    reduce: "psum" (shards summed in index order) or "ring" (the explicit
    reduce-scatter ring + all-gather, parallel/collectives.py)."""
    if reduce not in ("psum", "ring"):
        raise ValueError(f"unknown reduce {reduce!r}")
    allreduce = col.ring_allreduce if reduce == "ring" else col.psum
    f32_matmul()
    devs = axis_devices(mesh, axis)
    n = len(devs)

    def rep(x):
        return [x.to(d) for d in devs]

    cv = rep(sp.cam_valid)
    shards = [BAProblem(
        R=None, t=None, X=None, cam_idx=sp.cam_idx[s].to(d),
        lm_idx=sp.lm_idx[s].to(d), uv=sp.uv[s].to(d),
        obs_valid=sp.obs_valid[s].to(d), cam_valid=cv[s],
        lm_valid=sp.lm_valid[s].to(d)) for s, d in enumerate(devs)]
    R = rep(sp.R)
    t = rep(sp.t)
    X = [sp.X[s].to(d) for s, d in enumerate(devs)]
    # one set of segment-sum plans per shard, built once
    plans = [ba_plans(p.cam_idx, p.lm_idx, R[s].shape[0], X[s].shape[0])
             for s, p in enumerate(shards)]
    lam = [torch.full((), cfg.damping_init, dtype=x.dtype, device=x.device)
           for x in X]
    cost = col.psum([robust_cost(p, R[s], t[s], X[s], cfg.huber_delta)
                     for s, p in enumerate(shards)])
    init_cost = cost[0]

    for _ in range(cfg.iters):
        S, b, V_inv, bl, Wd = [], [], [], [], []
        for s, p in enumerate(shards):
            U, V, bc, bl_s, Wd_s = normal_equations(p, R[s], t[s], X[s], cfg,
                                                    plans[s])
            S_s, b_s, Vi = schur_camera_system(U, V, bc, bl_s, Wd_s, lam[s])
            S.append(S_s)
            b.append(b_s)
            V_inv.append(Vi)
            bl.append(bl_s)
            Wd.append(Wd_s)
        S = allreduce(S)                    # the one collective per iter
        b = allreduce(b)
        prop = []
        for s, p in enumerate(shards):
            dc = solve_cameras(S[s], b[s], p.cam_valid, lam[s], cfg)
            dl = backsub_landmarks(V_inv[s], bl[s], Wd[s], dc, p.lm_valid)
            prop.append(apply_increments(R[s], t[s], X[s], dc, dl))
        new_cost = col.psum([robust_cost(p, *prop[s], cfg.huber_delta)
                             for s, p in enumerate(shards)])
        for s in range(n):
            (R[s], t[s], X[s]), cost[s], lam[s] = lm_update(
                cfg, new_cost[s], cost[s], lam[s], prop[s],
                (R[s], t[s], X[s]))
    if reduce == "ring":
        # the JAX ring path closes with the mean of the replicated values
        # (there a type-system necessity); kept for equal results
        inv = 1.0 / n
        R = [r * inv for r in col.psum(R)]
        t = [v * inv for v in col.psum(t)]
        cost = [c * inv for c in col.psum(cost)]
        lam = [v * inv for v in col.psum(lam)]
    d0 = devs[0]
    return BAResult(R=R[0], t=t[0], X=torch.stack([x.to(d0) for x in X]),
                    cost=cost[0], initial_cost=init_cost,
                    lm_lambda=lam[0])

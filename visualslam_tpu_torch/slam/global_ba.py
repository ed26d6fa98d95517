"""Full-sequence (global) bundle adjustment over the ENTIRE keyframe history
(visualslam_tpu/slam/global_ba.py).

The SlamMap archives every evicted keyframe (pose + uid-keyed observations)
and snapshots landmark positions when slots are recycled, so after a run
the complete observation graph is recoverable:

    cameras    = archived keyframes + live window keyframes
    landmarks  = every uid observed by >= 2 of those cameras
    obs        = uid-validated normalized-plane measurements

The problem goes to backend/ba.run_ba on the device. As in the reference,
the dense Schur solver hands over to the matrix-free "schur_mf" above 64
cameras. With a mesh (parallel/mesh.Mesh) the trajectory axis is sharded
over its devices (parallel/traj_ba.run_ba_traj_sharded), cameras padded
to a multiple of the shard count.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from visualslam_tpu_torch.backend.ba import BAProblem, run_ba
from visualslam_tpu_torch.parallel.traj_ba import (
    pad_cameras,
    run_ba_traj_sharded,
    shard_problem_trajectory,
    unshard_traj,
)
from visualslam_tpu_torch.utils.config import BAConfig


class GlobalBAResult(NamedTuple):
    frame_ids: np.ndarray   # [K] keyframe frame ids
    R: np.ndarray           # [K, 3, 3] optimized world-to-camera
    t: np.ndarray           # [K, 3]
    cost: float
    initial_cost: float
    n_cameras: int
    n_landmarks: int
    n_observations: int


def _collect(slam_map, corrected: Optional[dict] = None):
    """Flatten archive + live window into (frame_id, R, t, uid, uv) per
    keyframe, by frame id. `corrected`: optional frame_id -> (R, t)
    overrides (loop-closure-corrected poses)."""
    kfs = []
    for a in slam_map.archive:
        kfs.append((a.frame_id, a.R, a.t, a.lm_uid, a.uv))
    for s in slam_map.kf_order:
        if not slam_map.kf_valid[s]:
            continue
        if s in slam_map.obs:
            lm_idx, lm_uid, uv = slam_map.obs[s]
            live = (slam_map.lm_valid[lm_idx]
                    & (slam_map.lm_uid[lm_idx] == lm_uid))
            uid, uv = lm_uid[live], uv[live]
        else:
            uid = np.zeros(0, np.int64)
            uv = np.zeros((0, 2), np.float32)
        kfs.append((int(slam_map.kf_frame_id[s]), slam_map.kf_R[s].copy(),
                    slam_map.kf_t[s].copy(), uid, uv))
    kfs.sort(key=lambda e: e[0])
    if corrected:
        kfs = [(fid, *(corrected.get(fid, (R, t))), uid, uv)
               for fid, R, t, uid, uv in kfs]
    return kfs


def _landmark_positions(slam_map) -> dict:
    pos = dict(slam_map.archived_lm_pos)
    for s in np.nonzero(slam_map.lm_valid)[0]:
        pos[int(slam_map.lm_uid[s])] = slam_map.X[s]
    return pos


def build_global_problem(slam_map, corrected: Optional[dict] = None,
                         min_obs: int = 2, pad_cameras_to: int = 1,
                         device="cuda"):
    """Returns (BAProblem on `device`, frame_ids [K]) over the full history.
    Capacities are the exact problem size (cameras rounded up to a multiple
    of `pad_cameras_to`)."""
    kfs = _collect(slam_map, corrected)
    K = len(kfs)
    if K < 2:
        raise ValueError("global BA needs at least 2 keyframes")

    # landmark set: uids observed by >= min_obs keyframes with a known pos
    counts: dict[int, int] = {}
    for _, _, _, uid, _ in kfs:
        for u in np.unique(uid):
            counts[int(u)] = counts.get(int(u), 0) + 1
    pos = _landmark_positions(slam_map)
    uids = sorted(u for u, c in counts.items() if c >= min_obs and u in pos)
    uid_to_l = {u: i for i, u in enumerate(uids)}
    L = len(uids)
    if L < 8:
        raise ValueError(f"global BA: only {L} multi-view landmarks")

    cams, lms, uvs = [], [], []
    for c, (_, _, _, uid, uv) in enumerate(kfs):
        sel = np.asarray([uid_to_l.get(int(u), -1) for u in uid], np.int64)
        keep = sel >= 0
        cams.append(np.full(int(keep.sum()), c, np.int64))
        lms.append(sel[keep])
        uvs.append(uv[keep])
    cam_idx = np.concatenate(cams)
    lm_idx = np.concatenate(lms)
    uv = np.concatenate(uvs).astype(np.float32)
    O = len(cam_idx)

    R = np.stack([Rc for _, Rc, _, _, _ in kfs]).astype(np.float32)
    t = np.stack([tc for _, _, tc, _, _ in kfs]).astype(np.float32)
    X = np.stack([pos[u] for u in uids]).astype(np.float32)

    def T(x):
        return torch.as_tensor(x, device=device)

    p = BAProblem(
        R=T(R), t=T(t), X=T(X),
        cam_idx=T(cam_idx.astype(np.int32)),
        lm_idx=T(lm_idx.astype(np.int32)),
        uv=T(uv), obs_valid=T(np.ones(O, bool)),
        cam_valid=T(np.ones(K, bool)), lm_valid=T(np.ones(L, bool)))
    return pad_cameras(p, pad_cameras_to), np.asarray(
        [fid for fid, *_ in kfs])


def run_global_ba(slam_map, cfg: BAConfig, corrected: Optional[dict] = None,
                  mesh=None, mesh_axis: str = "shard",
                  device="cuda") -> GlobalBAResult:
    """Optimize the full keyframe history, built on `device`. With `mesh`
    (parallel/mesh.Mesh), the trajectory axis is sharded across its devices
    (parallel/traj_ba.py); otherwise the single-device Schur solver runs."""
    n_shards = 1 if mesh is None else mesh.shape[mesh_axis]
    p, frame_ids = build_global_problem(slam_map, corrected,
                                        pad_cameras_to=n_shards,
                                        device=device)
    K = len(frame_ids)
    # as the reference: the dense default hands over to the matrix-free
    # Schur CG once the reduced system outgrows direct factorization
    solver = cfg.solver
    if p.R.shape[0] > 64 and solver == "schur_dense":
        solver = "schur_mf"
    run_cfg = cfg.replace(max_cameras=int(p.R.shape[0]),
                          max_landmarks=int(p.X.shape[0]),
                          max_observations=int(p.uv.shape[0]),
                          solver=solver)
    if mesh is None:
        res = run_ba(p, run_cfg)
        R = res.R[:K].cpu().numpy()
        t = res.t[:K].cpu().numpy()
    else:
        sp = shard_problem_trajectory(p, n_shards)
        res = run_ba_traj_sharded(sp, run_cfg, mesh, axis=mesh_axis)
        R, t, _ = unshard_traj(res.R, res.t, res.X, sp.lm_order,
                               int(p.X.shape[0]))
        R, t = R[:K], t[:K]
    return GlobalBAResult(
        frame_ids=frame_ids, R=R, t=t, cost=float(res.cost),
        initial_cost=float(res.initial_cost), n_cameras=K,
        n_landmarks=int(p.X.shape[0]), n_observations=int(p.uv.shape[0]))

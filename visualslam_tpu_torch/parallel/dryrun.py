"""Mesh dry run (visualslam_tpu/parallel/dryrun.py): the distributed paths
of a sequence step on an n-shard mesh at small shapes, except the last,
which is sequence-scale:

  1. the data-parallel SIFT frontend (each 'data' shard detects its frames,
     then a psum of the detection count),
  2. the fused per-frame tracking program (slam/track_step.track_step_jit),
  3. the landmark-sharded Schur BA (all-reduced reduced camera system),
  4. the trajectory-sharded BA over a multi-keyframe window (camera blocks
     per shard, ring Schur reduce-scatter, distributed CG), and
  5. the matrix-free trajectory-sharded BA at C = 1024, L = 4096.

`run_dryrun(n, devices=[torch.device("cpu")] * n)` runs it on a virtual
CPU mesh, eagerly; without `devices` the mesh is the first n CUDA devices.
On a virtual mesh of one card (`devices=[cuda] * n`) every step replays
captured CUDA graphs, as the JAX package jits each
(parallel/programs.py); the `dryrun_*` functions give each step's inputs.
"""

from __future__ import annotations

import numpy as np
import torch

from visualslam_tpu_torch.backend.ba import BAProblem
from visualslam_tpu_torch.frontend import SiftFrontend, frontend_module
from visualslam_tpu_torch.parallel import collectives as col
from visualslam_tpu_torch.parallel.mesh import Mesh, axis_devices, make_mesh
from visualslam_tpu_torch.parallel.programs import MeshGraphProgram, MeshKey
from visualslam_tpu_torch.utils.config import DEFAULT_CONFIG, BAConfig


def _dp_frontend(x: tuple, cfg: tuple) -> tuple:
    """The data-parallel frontend over the mesh: x = one [per, H, W]
    chunk of frames per shard, on its device; cfg = (MeshKey(SlamConfig,
    ...), Kernels). Each chunk goes through the process's frontend module
    of (config, kernels) on its device (frontend.frontend_module), then
    the detection counts are psum'd. Returns (Features per shard, the
    total per shard)."""
    key, kernels = cfg
    feats = tuple(frontend_module(key.cfg, kernels, c.device)(c) for c in x)
    total = col.psum([f.keypoints.valid.sum() for f in feats])
    return feats, tuple(total)


_DP_FRONTEND = MeshGraphProgram(_dp_frontend)


def frontend_args(frontend, frames, mesh: Mesh, axis: str = "data") -> tuple:
    """data_parallel_frontend's program arguments (x, (MeshKey, kernels)):
    each shard's contiguous block of `frames` on its device (numpy frames
    are uploaded here, outside any capture) and the static key of the
    module's config and kernel set."""
    devs = axis_devices(mesh, axis)
    n = len(devs)
    N = frames.shape[0]
    if N % n:
        raise ValueError(f"{N} frames do not split over {n} shards")
    if isinstance(frames, np.ndarray):
        frames = torch.from_numpy(np.ascontiguousarray(frames))
    per = N // n
    x = tuple(frames[s * per:(s + 1) * per].to(d) for s, d in enumerate(devs))
    return x, (MeshKey(frontend.cfg, devs, axis), frontend.kernels)


def data_parallel_frontend(frontend, frames, mesh: Mesh, axis: str = "data"):
    """Each shard of `axis` runs the frontend of `frontend`'s config and
    kernel set (an nn.Module of frontend.py, e.g. SiftFrontend; the
    process's module of that config on each shard's device,
    `frontend.frontend_module`) on its contiguous block of `frames`
    [N, H, W] (numpy or tensor, N a multiple of the shard count), then the
    detection counts are psum'd. Returns (one batched Features per shard,
    on its device; the total detection count, one 0-d tensor per shard).

    On a mesh whose shards are all one CUDA device every shard's frontend
    and the psum replay one captured graph per shape key and (config,
    kernels, devices, axis) (parallel/programs.MeshGraphProgram; the JAX
    package's jitted shard_map); on the CPU, over several devices and for
    the plain kernel set they run eagerly. The results are the
    caller's."""
    feats, total = _DP_FRONTEND(*frontend_args(frontend, frames, mesh, axis))
    return list(feats), list(total)


data_parallel_frontend.program = _DP_FRONTEND


DRYRUN_FRONTEND_CONFIG = DEFAULT_CONFIG.replace(image_height=64,
                                                image_width=96)


def dryrun_frames(n_devices: int) -> np.ndarray:
    """The frontend dry run's frames: one 64x96 float frame a shard."""
    rng = np.random.default_rng(0)
    return rng.random((n_devices, 64, 96), dtype=np.float32)


def _dryrun_frontend(n_devices: int, devices=None) -> None:
    mesh = make_mesh(n_devices, axis="data", devices=devices)
    feats, total = data_parallel_frontend(
        SiftFrontend(DRYRUN_FRONTEND_CONFIG), dryrun_frames(n_devices), mesh)
    assert len(feats) == n_devices
    print(f"[dryrun] frontend mesh={dict(mesh.shape)} "
          f"total_detections={int(total[0])}")


def _problem(R, t, X, cam_idx, lm_idx, uv, valid, device) -> BAProblem:
    def T(x, dtype=None):
        return torch.as_tensor(np.asarray(x, dtype), device=device)

    C, L = len(R), len(X)
    return BAProblem(
        R=T(R, np.float32), t=T(t, np.float32), X=T(X, np.float32),
        cam_idx=T(cam_idx, np.int32), lm_idx=T(lm_idx, np.int32),
        uv=T(uv, np.float32), obs_valid=T(valid),
        cam_valid=T(np.ones(C, bool)), lm_valid=T(np.ones(L, bool)))


def _rot_y(a: float) -> np.ndarray:
    c, s = np.cos(a), np.sin(a)
    return np.array([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]])


def dryrun_ba_problem(n_devices: int, device) -> BAProblem:
    """The landmark-sharded dry run's problem: C = 4 cameras, 16
    landmarks a shard, each seen by every camera, landmarks perturbed by
    0.05."""
    rng = np.random.default_rng(1)
    C, L = 4, 16 * n_devices
    X = rng.uniform([-2, -2, 5], [2, 2, 9], (L, 3))
    R = np.stack([_rot_y(0.02 * c) for c in range(C)])
    t = np.stack([np.array([-0.3 * c, 0.0, 0.0]) for c in range(C)])
    cam_idx = np.tile(np.arange(C), L)
    lm_idx = np.repeat(np.arange(L), C)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:]
    return _problem(R, t, X + rng.normal(0, 0.05, X.shape), cam_idx, lm_idx,
                    uv, np.ones(len(cam_idx), bool), device)


DRYRUN_BA_CONFIG = BAConfig(iters=3)


def _dryrun_ba(n_devices: int, devices=None) -> None:
    from visualslam_tpu_torch.parallel.dist_ba import (
        run_ba_sharded,
        shard_problem,
    )

    mesh = make_mesh(n_devices, axis="shard", devices=devices)
    p = dryrun_ba_problem(n_devices, mesh.devices[0])
    res = run_ba_sharded(shard_problem(p, n_devices), DRYRUN_BA_CONFIG, mesh)
    print(f"[dryrun] sharded BA mesh={dict(mesh.shape)} "
          f"cost {float(res.initial_cost):.3e} -> {float(res.cost):.3e}")
    assert float(res.cost) < float(res.initial_cost)


DRYRUN_TRACK_CONFIG = DEFAULT_CONFIG.replace(
    sift=DEFAULT_CONFIG.sift.replace(max_keypoints=64),
    match=DEFAULT_CONFIG.match.replace(max_matches=32),
    local_map_size=64)


def dryrun_track_inputs(device) -> tuple:
    """The track-step dry run's (kf, lmap, feats, state, intr) on
    `device`: 64 random keypoints and descriptors per frame, a 64-point
    local map."""
    from visualslam_tpu_torch.models.types import Features, Keypoints
    from visualslam_tpu_torch.slam.track_step import (
        KeyframeRef,
        LocalMap,
        TrackState,
    )

    dev = device
    rng = np.random.default_rng(2)
    K, D, Kl = 64, 128, 64

    def feats(seed):
        r = np.random.default_rng(seed)
        kps = Keypoints.empty(K, dev)._replace(
            yx=torch.as_tensor(r.uniform(0, 60, (K, 2)).astype(np.float32),
                               device=dev),
            valid=torch.ones(K, dtype=torch.bool, device=dev))
        return Features(kps, torch.as_tensor(
            r.standard_normal((K, D)).astype(np.float32), device=dev))

    f0 = feats(0)
    kf = KeyframeRef(desc=f0.descriptors, yx=f0.keypoints.yx,
                     kp_valid=torch.ones(K, dtype=torch.bool, device=dev),
                     kp_has_lm=torch.zeros(K, dtype=torch.bool, device=dev),
                     R=torch.eye(3, device=dev),
                     t=torch.zeros(3, device=dev))
    lmap = LocalMap(desc=feats(1).descriptors,
                    X=torch.as_tensor(rng.uniform(-2, 2, (Kl, 3)),
                                      dtype=torch.float32, device=dev),
                    valid=torch.ones(Kl, dtype=torch.bool, device=dev))
    state = TrackState(R=torch.eye(3, device=dev),
                       t=torch.zeros(3, device=dev),
                       vel=torch.zeros(6, device=dev))
    intr = torch.tensor([60.0, 60.0, 30.0, 30.0], device=dev)
    return kf, lmap, feats(2), state, intr


DRYRUN_TRACK_ARGS = (10, 100.0)     # min_inliers, max_depth


def _dryrun_track_step(n_devices: int, devices=None) -> None:
    """The fused per-frame tracking program at small shapes (the sequence
    step between frontend and backend), on the mesh's first device,
    through track_step_jit (the JAX package's jitted track_step)."""
    from visualslam_tpu_torch.slam.track_step import track_step_jit

    dev = make_mesh(n_devices, axis="shard", devices=devices).devices[0]
    out = track_step_jit(*dryrun_track_inputs(dev), DRYRUN_TRACK_CONFIG,
                         *DRYRUN_TRACK_ARGS)
    print(f"[dryrun] fused track_step OK (stats[:4]="
          f"{out.stats[:4].cpu().numpy().round(2).tolist()})")


def dryrun_traj_problem(n_devices: int, device) -> BAProblem:
    """The trajectory-sharded dry run's window: 2 cameras and 8 landmarks
    a shard, each landmark seen by every camera, perturbed by 0.03."""
    rng = np.random.default_rng(3)
    C, L = 2 * n_devices, 8 * n_devices      # multi-keyframe window
    X = rng.uniform([-2, -2, 5], [2, 2, 9], (L, 3))
    R = np.stack([_rot_y(0.01 * c) for c in range(C)])
    t = np.stack([np.array([-0.2 * c, 0.0, 0.0]) for c in range(C)])
    cam_idx = np.tile(np.arange(C), L)
    lm_idx = np.repeat(np.arange(L), C)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:]
    return _problem(R, t, X + rng.normal(0, 0.03, X.shape), cam_idx, lm_idx,
                    uv, np.ones(len(cam_idx), bool), device)


DRYRUN_TRAJ_CONFIG = BAConfig(iters=3, cg_iters=32)


def _dryrun_traj_ba(n_devices: int, devices=None) -> None:
    """Trajectory-sharded window BA: Cs cameras per shard, covisibility
    landmark partition, ring reduce-scatter Schur assembly, distributed
    CG solve."""
    from visualslam_tpu_torch.parallel.traj_ba import (
        run_ba_traj_sharded,
        shard_problem_trajectory,
    )

    mesh = make_mesh(n_devices, axis="shard", devices=devices)
    p = dryrun_traj_problem(n_devices, mesh.devices[0])
    sp = shard_problem_trajectory(p, n_devices)
    res = run_ba_traj_sharded(sp, DRYRUN_TRAJ_CONFIG, mesh)
    print(f"[dryrun] traj-sharded BA mesh={dict(mesh.shape)} "
          f"C={p.R.shape[0]} (x{n_devices} blocks) cost "
          f"{float(res.initial_cost):.3e} -> {float(res.cost):.3e}")
    assert float(res.cost) < float(res.initial_cost)


def traj_mf_problem(device) -> BAProblem:
    """The sequence-scale problem of the matrix-free dry run: C = 1024
    cameras on a slow yawing dolly, L = 4096 landmarks, each seen by 4
    consecutive cameras (~16k observations, the off-image ones invalid),
    landmarks perturbed by 0.1."""
    rng = np.random.default_rng(4)
    C, L, per = 1024, 4096, 4
    ks = np.arange(C)
    cw = np.stack([0.05 * ks, np.zeros(C), 0.4 * ks], -1)
    R = np.stack([_rot_y(a) for a in 0.002 * ks])
    t = -np.einsum("cij,cj->ci", R, cw)
    anchor = (np.arange(L) / L * C * 0.4).astype(np.float32)
    X = np.stack([rng.uniform(-20, 20, L), rng.uniform(-10, 10, L),
                  anchor + rng.uniform(8, 40, L)], -1)
    base_cam = np.clip((anchor / 0.4).astype(np.int64), 0, C - 1 - per)
    cam_idx = (base_cam[:, None] + np.arange(per)[None]).reshape(-1)
    lm_idx = np.repeat(np.arange(L), per)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    z = np.maximum(Xc[:, 2], 1e-3)
    uv = Xc[:, :2] / z[:, None]
    valid = (Xc[:, 2] > 1.0) & (np.abs(uv) < 1.5).all(1)
    return _problem(R, t, X + rng.normal(0, 0.1, X.shape), cam_idx, lm_idx,
                    uv, valid, device)


TRAJ_MF_CONFIG = BAConfig(iters=2, cg_iters=24, solver="schur_mf")


def _dryrun_traj_ba_mf(n_devices: int, devices=None) -> None:
    """Sequence-scale trajectory-sharded BA with the MATRIX-FREE
    distributed solver: per CG matvec one [C, 6] psum; the dense path
    would materialize [Cs, 6, C, 6] Schur rows per shard."""
    from visualslam_tpu_torch.parallel.traj_ba import (
        run_ba_traj_sharded,
        shard_problem_trajectory,
    )

    mesh = make_mesh(n_devices, axis="shard", devices=devices)
    p = traj_mf_problem(mesh.devices[0])
    sp = shard_problem_trajectory(p, n_devices)
    res = run_ba_traj_sharded(sp, TRAJ_MF_CONFIG, mesh)
    print(f"[dryrun] traj-sharded MATRIX-FREE BA mesh={dict(mesh.shape)} "
          f"C={p.R.shape[0]} L={p.X.shape[0]} cost "
          f"{float(res.initial_cost):.3e} -> {float(res.cost):.3e}")
    assert float(res.cost) < float(res.initial_cost)


def run_dryrun(n_devices: int, devices=None) -> None:
    _dryrun_frontend(n_devices, devices)
    _dryrun_track_step(n_devices, devices)
    _dryrun_ba(n_devices, devices)
    _dryrun_traj_ba(n_devices, devices)
    _dryrun_traj_ba_mf(n_devices, devices)

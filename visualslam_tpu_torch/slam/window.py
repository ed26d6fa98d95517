"""Drivers of the tracking slices from a ground-truth bootstrap: keyframes
at two known poses (`bootstrap`), then either one tracking window
(`run_window`: track_batch over the batch, one keyframe promotion with
triangulation, and the window BA) or the engine (`run_engine`: the
engine batch over consecutive batches, the persist chained device to
device).

The bootstrap stands in for the host tracker's two-view init (8-point
RANSAC and scale, slam/tracker.Tracker): the first two keyframes sit at
ground-truth world-to-camera poses, so the map is at the sequence's own
scale and both packages start from the same map. What follows is the tracker's own sequence
(visualslam_tpu/slam/tracker.py): `max_depth` is 20 x the median depth of
the first triangulation, the tracking floor is
max(10, keyframe_min_inliers // 3), map updates on promotion follow
`_insert_keyframe_from_track` and the BA problem `_run_window_ba`.

Both drivers are written against the API the port shares with the JAX
package (track_step, ba, map_state, se3, engine): pass `port_ops(device)`
to run the port, or an equivalent namespace of the JAX package's functions
to run the reference on the same features.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace
from typing import Any, NamedTuple

import numpy as np
import torch

from visualslam_tpu_torch.backend import ba
from visualslam_tpu_torch.geometry import se3
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.slam import engine
from visualslam_tpu_torch.slam import track_step as ts
from visualslam_tpu_torch.slam.map_state import SlamMap
from visualslam_tpu_torch.utils.config import SlamConfig


class WindowRun(NamedTuple):
    """What one window produced (numpy), and the inputs of its device calls
    (backend arrays, for timing them again)."""

    R: np.ndarray            # [B, 3, 3] tracked world-to-camera per frame
    t: np.ndarray            # [B, 3]
    ok: np.ndarray           # [B] bool tracking accepted (False before start)
    inliers: np.ndarray      # [B] PnP inliers
    new_landmarks: tuple     # (at the second keyframe, at the promotion)
    ba_sizes: tuple          # (cameras, landmarks, observations)
    ba_cost: tuple           # (initial, final)
    kf_R: np.ndarray         # [3, 3, 3] keyframe poses after the BA
    kf_t: np.ndarray         # [3, 3]
    max_depth: float
    calls: dict              # inputs of track_batch, keyframe_step, run_ba


def world_to_camera(gt_poses: np.ndarray):
    """Ground-truth camera-to-world poses [F, 3, 4] (SequenceInfo.gt_poses)
    -> world-to-camera (R [F, 3, 3], t [F, 3]) float32, as run_window takes
    them."""
    R = np.transpose(gt_poses[:, :, :3], (0, 2, 1))
    t = -np.einsum("fij,fj->fi", R, gt_poses[:, :, 3])
    return R.astype(np.float32), t.astype(np.float32)


def port_ops(device="cuda", kernels: Kernels = KERNELS) -> SimpleNamespace:
    """This package's functions for `run_window` and `run_engine`, on
    `device` (the card unless the caller passes device="cpu"). The engine
    batch is engine_programs' "batch": captured CUDA graphs on the card,
    run_engine_batch itself on the CPU."""

    def run_engine_batch(persist, dyn, feats_b, intr, cfg, ok_min,
                         max_depth):
        return engine.engine_programs(cfg, ok_min, max_depth)["batch"](
            persist, dyn, feats_b, intr, kernels)

    return SimpleNamespace(
        run_engine_batch=run_engine_batch,
        build_persist_from_host=functools.partial(
            engine.build_persist_from_host, device=device),
        engine_dyn=functools.partial(engine.engine_dyn, device=device),
        decode_packed=engine.decode_packed,
        track_batch=functools.partial(ts.track_batch, kernels=kernels),
        keyframe_step=functools.partial(ts.keyframe_step, kernels=kernels),
        lite_at=ts.lite_at, index_features=ts.index_features,
        build_local_map=functools.partial(ts.build_local_map, device=device),
        pack_keyframe_products=ts.pack_keyframe_products,
        unpack_keyframe_products=ts.unpack_keyframe_products,
        TrackAssoc=ts.TrackAssoc, TrackState=ts.TrackState,
        KeyframeRef=ts.KeyframeRef, TrackLite=ts.TrackLite,
        BAProblem=ba.BAProblem, run_ba=ba.run_ba, SlamMap=SlamMap, se3=se3,
        asarray=lambda a: torch.as_tensor(np.asarray(a), device=device),
        tonumpy=lambda x: x.detach().cpu().numpy())


def _assoc(ops, out, feats, M: int, K: int):
    """TrackAssoc of a keyframe_step output, through one packed read-back."""
    packed = ops.tonumpy(ops.pack_keyframe_products(out, feats))
    _, ai, af, _, _, _ = ops.unpack_keyframe_products(packed, M, K)
    return ops.TrackAssoc.unpack(ai, af)


def _keyframe(ops, smap, fid: int, R, t, feats) -> int:
    slot, _ = smap.allocate_keyframe()
    smap.set_keyframe(slot, fid, R, t, ops.tonumpy(feats.descriptors),
                      ops.tonumpy(feats.keypoints.yx),
                      ops.tonumpy(feats.keypoints.valid))
    return slot


def _keyframe_ref(ops, smap, slot: int):
    return ops.KeyframeRef(
        desc=ops.asarray(smap.kf_desc[slot]),
        yx=ops.asarray(np.asarray(smap.kf_yx[slot], np.float32)),
        kp_valid=ops.asarray(smap.kf_kp_valid[slot]),
        kp_has_lm=ops.asarray(smap.kf_kp_lm[slot] >= 0),
        R=ops.asarray(smap.kf_R[slot]), t=ops.asarray(smap.kf_t[slot]))


def _add_triangulated(smap, prev: int, slot: int, d) -> int:
    """New landmarks from the gated triangulation (tracker.py:1118-1125)."""
    good = np.asarray(d.tri_good)
    if good.any():
        lm_idx = smap.allocate_landmarks(d.tri_X[good])
        smap.add_observations(prev, lm_idx, d.m_x1[good])
        smap.add_observations(slot, lm_idx, d.m_x2[good])
        smap.kf_kp_lm[prev][d.m_idx_a[good]] = lm_idx
        smap.kf_kp_lm[slot][d.m_idx_b[good]] = lm_idx
    return int(good.sum())


class Bootstrap(NamedTuple):
    """The map after the ground-truth bootstrap, and the tracker state it
    hands on (numpy)."""

    map: Any                 # SlamMap: keyframes kf0, kf1 + first landmarks
    R: np.ndarray            # [3, 3] pose state: keyframe kf1 (ground truth)
    t: np.ndarray            # [3]
    vel: np.ndarray          # [6] constant-velocity twist into kf1
    max_depth: float         # 20 x the median depth of the first landmarks
    ok_min: int              # PnP inliers below which tracking is rejected
    slots: tuple             # map slots of (kf0, kf1)
    new_landmarks: int       # landmarks triangulated between kf0 and kf1


def bootstrap(ops, feats_b, R_gt: np.ndarray, t_gt: np.ndarray, intr,
              cfg: SlamConfig, kf0: int = 0, kf1: int = 4) -> Bootstrap:
    """Keyframes kf0 and kf1 of batched Features at their ground-truth
    world-to-camera poses, and the landmarks triangulated between them
    (stands in for the host tracker's two-view init)."""
    K = int(feats_b.descriptors.shape[1])
    M = cfg.match.max_matches
    A = ops.asarray
    smap = ops.SlamMap(cfg.ba.max_cameras, cfg.map_landmarks, K)
    f0 = ops.index_features(feats_b, kf0)
    f1 = ops.index_features(feats_b, kf1)
    s0 = _keyframe(ops, smap, kf0, R_gt[kf0], t_gt[kf0], f0)
    ref0 = _keyframe_ref(ops, smap, s0)
    # constant-velocity twist of the frame before kf1 -> kf1
    vel = ops.tonumpy(ops.se3.se3_log(*ops.se3.compose(
        A(R_gt[kf1]), A(t_gt[kf1]),
        *ops.se3.inverse(A(R_gt[kf1 - 1]), A(t_gt[kf1 - 1])))))
    lite1 = ops.TrackLite(
        R=A(R_gt[kf1]), t=A(t_gt[kf1]), vel=A(vel),
        stats=A(np.zeros(22, np.float32)),
        ml_idx_a=A(np.zeros(M, np.int32)), ml_idx_b=A(np.zeros(M, np.int32)),
        ml_gated=A(np.zeros(M, bool)), ml_inlier=A(np.zeros(M, bool)),
        ml_x=A(np.zeros((M, 2), np.float32)), ok=A(np.asarray(True)))
    # the depth gate is 20 x the median depth of the first triangulation
    # (the tracker's init_depth * 20), so triangulate once without it
    d = _assoc(ops, ops.keyframe_step(ref0, f1, lite1, intr, cfg, 1e9),
               f1, M, K)
    z = (d.tri_X[d.tri_good] @ R_gt[kf0].T + t_gt[kf0])[:, 2]
    if z.size == 0:
        raise RuntimeError("bootstrap: no point passed the triangulation gates")
    max_depth = 20.0 * float(np.median(z))
    d = _assoc(ops, ops.keyframe_step(ref0, f1, lite1, intr, cfg, max_depth),
               f1, M, K)
    s1 = _keyframe(ops, smap, kf1, R_gt[kf1], t_gt[kf1], f1)
    n_new = _add_triangulated(smap, s0, s1, d)
    return Bootstrap(map=smap, R=R_gt[kf1], t=t_gt[kf1], vel=vel,
                     max_depth=max_depth,
                     ok_min=max(10, cfg.keyframe_min_inliers // 3),
                     slots=(s0, s1), new_landmarks=n_new)


def run_window(ops, feats_b, R_gt: np.ndarray, t_gt: np.ndarray, intr,
               cfg: SlamConfig, kf0: int = 0, kf1: int = 4, start: int = 5,
               promote: int = 12) -> WindowRun:
    """feats_b: batched Features [B, K, ...] (backend arrays); R_gt [B, 3, 3],
    t_gt [B, 3]: ground-truth world-to-camera poses (numpy float32); intr:
    [4] backend array. Keyframes kf0 and kf1 at ground truth, track frames
    start..B-1, promote frame `promote`, then the window BA."""
    K = int(feats_b.descriptors.shape[1])
    D = int(feats_b.descriptors.shape[2])
    M = cfg.match.max_matches
    A = ops.asarray
    boot = bootstrap(ops, feats_b, R_gt, t_gt, intr, cfg, kf0, kf1)
    smap, (_, s1), max_depth = boot.map, boot.slots, boot.max_depth
    ok_min, n_new1 = boot.ok_min, boot.new_landmarks

    # track every frame of the batch against the local map
    lmap, ids = ops.build_local_map(smap, cfg.local_map_size, D, np.float32)
    state = ops.TrackState(R=A(boot.R), t=A(boot.t), vel=A(boot.vel))
    _, lites = ops.track_batch(lmap, feats_b, start, state, intr, cfg, ok_min)

    # promote one tracked frame (tracker.py:1110-1125)
    ref1 = _keyframe_ref(ops, smap, s1)
    fp = ops.index_features(feats_b, promote)
    lite_p = ops.lite_at(lites, promote)
    d = _assoc(ops, ops.keyframe_step(ref1, fp, lite_p, intr, cfg, max_depth),
               fp, M, K)
    s2 = _keyframe(ops, smap, promote, ops.tonumpy(lite_p.R),
                   ops.tonumpy(lite_p.t), fp)
    lm_ids = ids[np.maximum(d.lm_slot, 0)]
    tracked = d.lm_valid & d.lm_inlier & (lm_ids >= 0)
    if tracked.any():
        smap.add_observations(s2, lm_ids[tracked], d.lm_x[tracked])
        smap.kf_kp_lm[s2][d.lm_kp[tracked]] = lm_ids[tracked]
    n_new2 = _add_triangulated(smap, s1, s2, d)

    # window BA (tracker.py:1225-1248)
    bcfg = cfg.ba
    (slots, R, t, lm_slots, X, cam_idx, lm_idx, uv,
     valid) = smap.build_ba_arrays(bcfg.max_observations)
    C, L = bcfg.max_cameras, bcfg.max_landmarks
    nC, nL = len(slots), len(lm_slots)
    if nL > L:
        raise RuntimeError(f"window BA: {nL} landmarks exceed capacity {L}")
    p = ops.BAProblem(
        R=A(np.concatenate([R, np.tile(np.eye(3, dtype=np.float32),
                                       (C - nC, 1, 1))])),
        t=A(np.concatenate([t, np.zeros((C - nC, 3), np.float32)])),
        X=A(np.concatenate([X, np.zeros((L - nL, 3), np.float32)])),
        cam_idx=A(cam_idx.astype(np.int32)), lm_idx=A(lm_idx.astype(np.int32)),
        uv=A(uv.astype(np.float32)), obs_valid=A(valid),
        cam_valid=A(np.arange(C) < nC), lm_valid=A(np.arange(L) < nL))
    res = ops.run_ba(p, bcfg)
    smap.writeback_ba(slots, lm_slots, ops.tonumpy(res.R)[:nC],
                      ops.tonumpy(res.t)[:nC], ops.tonumpy(res.X)[:nL])

    stats = ops.tonumpy(lites.stats)
    calls: dict[str, Any] = dict(
        lmap=lmap, state=state, start=start, ok_min=ok_min, kf_ref=ref1,
        feats=fp, lite=lite_p, problem=p)
    return WindowRun(
        R=ops.tonumpy(lites.R), t=ops.tonumpy(lites.t),
        ok=ops.tonumpy(lites.ok), inliers=stats[:, 1],
        new_landmarks=(n_new1, n_new2),
        ba_sizes=(nC, nL, int(valid.sum())),
        ba_cost=(float(ops.tonumpy(res.initial_cost)),
                 float(ops.tonumpy(res.cost))),
        kf_R=smap.kf_R[slots].copy(), kf_t=smap.kf_t[slots].copy(),
        max_depth=max_depth, calls=calls)


class EngineRun(NamedTuple):
    """What run_engine produced (numpy), and each batch's inputs (backend
    arrays, for timing a batch again)."""

    R: np.ndarray            # [F, 3, 3] world-to-camera after each frame
    t: np.ndarray            # [F, 3]
    inliers: np.ndarray      # [F] PnP inliers (0 on inactive frames)
    promoted: np.ndarray     # [F] bool
    proms: list              # per batch, its PromRecords
    db_n: list               # per batch, the loop-database size after it
    tails: list              # per batch, its EngineTail
    max_depth: float
    ok_min: int
    calls: list              # per batch, (persist, dyn) it started from


def run_engine(ops, feats_batches, R_gt: np.ndarray, t_gt: np.ndarray, intr,
               cfg: SlamConfig, start: int = 5) -> EngineRun:
    """The engine over consecutive batches of Features [B, K, ...] (backend
    arrays): the ground-truth bootstrap from batch 0 (keyframes 0 and 4),
    the persist built from its map, then run_engine_batch on every batch
    in order (frames [start, B) of batch 0, all frames after), the persist
    chained device to device, each packed buffer decoded.

    The host tracker's mirror of the promotions into its map
    (slam/tracker.Tracker._engine_apply_prom) is not part of this driver:
    the engine's own device state carries the run."""
    B = int(feats_batches[0].descriptors.shape[0])
    M = cfg.match.max_matches
    W = cfg.ba.max_cameras
    Kl = cfg.local_map_size
    P = max(1, -(-B // max(1, cfg.keyframe_min_gap)))
    boot = bootstrap(ops, feats_batches[0], R_gt, t_gt, intr, cfg)
    persist, _, _ = ops.build_persist_from_host(
        boot.map, cfg, boot.R, boot.t, boot.vel, 0)
    stats, proms, db_n, tails, calls = [], [], [], [], []
    for k, feats_b in enumerate(feats_batches):
        dyn = ops.engine_dyn(B * k, start if k == 0 else 0, B, Kl)
        calls.append((persist, dyn))
        packed, persist = ops.run_engine_batch(persist, dyn, feats_b, intr,
                                               cfg, boot.ok_min,
                                               boot.max_depth)
        st, recs, n, tail = ops.decode_packed(ops.tonumpy(packed), B, M, P,
                                              W, Kl)
        stats.append(st)
        proms.append(recs)
        db_n.append(n)
        tails.append(tail)
    stats = np.concatenate(stats)
    return EngineRun(
        R=stats[:, 4:13].reshape(-1, 3, 3), t=stats[:, 13:16],
        inliers=stats[:, 1], promoted=stats[:, 22] > 0.5, proms=proms,
        db_n=db_n, tails=tails, max_depth=boot.max_depth,
        ok_min=boot.ok_min, calls=calls)

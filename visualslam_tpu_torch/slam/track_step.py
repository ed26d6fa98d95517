"""Per-frame tracking (visualslam_tpu/slam/track_step.py).

Every frame: local-map 3D-2D matching -> projection gate -> motion-only PnP
(LM) -> constant-velocity update (`track_step_lite`). On the frames the
host promotes to keyframes: 2D-2D matching against the last keyframe, DLT
triangulation and the acceptance gates for new landmarks
(`keyframe_step`). `track_batch` tracks every frame of a detected batch in
a Python loop with the pose state chained on the device.

Every data-dependent choice is a `torch.where`: no Python branch reads a
tensor value, so tracking a batch issues no host sync of its own. Poses
chain device to device; the per-match association arrays are packed into
two buffers and read back only on keyframes. The matchers take `kernels`
(ops.cuda.KERNELS by default, ops.cuda.PLAIN for the plain path); with
`cfg.match.impl="pallas"` they run the streaming 2-NN kernel.
`index_features` / `lite_at` take a frame index as a Python int (views) or
a 0-d device tensor (copies with no host sync), so one captured graph
serves every frame index. `track_step_jit` is the JAX package's jitted
track_step: on the card one captured CUDA graph per shape key
(`utils.graphs.GraphProgram`, seedless), on the CPU the function itself.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualslam_tpu_torch.backend.pnp import refine_pose
from visualslam_tpu_torch.geometry import se3
from visualslam_tpu_torch.geometry.camera import normalized
from visualslam_tpu_torch.geometry.epipolar import triangulate
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.precision import f32_matmul


class TrackState(NamedTuple):
    """Tracker state chained frame to frame on the device."""

    R: torch.Tensor     # [3, 3] world-to-camera of the last processed frame
    t: torch.Tensor     # [3]
    vel: torch.Tensor   # [6] constant-velocity twist


class KeyframeRef(NamedTuple):
    """Snapshot of the last keyframe (2D-2D matching source)."""

    desc: torch.Tensor       # [K, D]
    yx: torch.Tensor         # [K, 2]
    kp_valid: torch.Tensor   # [K] bool
    kp_has_lm: torch.Tensor  # [K] bool: keypoint already has a landmark
    R: torch.Tensor          # [3, 3]
    t: torch.Tensor          # [3]


class LocalMap(NamedTuple):
    """Covisible-landmark set (3D-2D matching source), rebuilt on the host
    at every keyframe; the global landmark id of each slot stays on the
    host (`build_local_map`)."""

    desc: torch.Tensor   # [Kl, D] representative descriptor per landmark
    X: torch.Tensor      # [Kl, 3] world positions
    valid: torch.Tensor  # [Kl] bool


class TrackOut(NamedTuple):
    """Everything one keyframe produces. `stats` packs the per-frame
    scalars into one [22] tensor:
      [0] 2D-2D match count vs the last keyframe (keyframe_step) or the
          local-map gated match count (track_step_lite)
      [1] PnP inlier count   [2] PnP cost
      [3] local-map gated match count   [4:13] R   [13:16] t   [16:22] vel.
    The association outputs are packed into two buffers (see TrackAssoc)."""

    R: torch.Tensor
    t: torch.Tensor
    vel: torch.Tensor
    stats: torch.Tensor      # [22] float32
    assoc_i: torch.Tensor    # [M, 6] int32, see TrackAssoc
    assoc_f: torch.Tensor    # [M, 9] float32, see TrackAssoc


class TrackAssoc(NamedTuple):
    """Host-side unpacked view of TrackOut.assoc_i / assoc_f.

    assoc_i columns: 0 lm_slot, 1 lm_kp, 2 lm flags (bit0 valid&gated,
    bit1 PnP inlier), 3 m_idx_a, 4 m_idx_b, 5 m flags (bit0 match valid,
    bit1 triangulation accepted).
    assoc_f columns: 0:2 lm_x, 2:4 m_x1, 4:6 m_x2, 6:9 tri_X."""

    lm_slot: np.ndarray      # [M] local-map slot
    lm_kp: np.ndarray        # [M] current keypoint index
    lm_valid: np.ndarray     # [M] bool (gated)
    lm_inlier: np.ndarray    # [M] bool PnP inlier
    lm_x: np.ndarray         # [M, 2] normalized observation
    m_idx_a: np.ndarray      # [M] keyframe keypoint
    m_idx_b: np.ndarray      # [M] current keypoint
    m_valid: np.ndarray      # [M] bool
    m_x1: np.ndarray         # [M, 2] normalized coords in keyframe
    m_x2: np.ndarray         # [M, 2] normalized coords in current frame
    tri_X: np.ndarray        # [M, 3] triangulated world points
    tri_good: np.ndarray     # [M] bool passed all acceptance gates

    @staticmethod
    def unpack(assoc_i: np.ndarray, assoc_f: np.ndarray) -> "TrackAssoc":
        ai = np.asarray(assoc_i)
        af = np.asarray(assoc_f)
        return TrackAssoc(
            lm_slot=ai[:, 0], lm_kp=ai[:, 1],
            lm_valid=(ai[:, 2] & 1).astype(bool),
            lm_inlier=(ai[:, 2] & 2).astype(bool),
            lm_x=af[:, 0:2],
            m_idx_a=ai[:, 3], m_idx_b=ai[:, 4],
            m_valid=(ai[:, 5] & 1).astype(bool),
            tri_good=(ai[:, 5] & 2).astype(bool),
            m_x1=af[:, 2:4], m_x2=af[:, 4:6], tri_X=af[:, 6:9],
        )


class TrackLite(NamedTuple):
    """Per-frame tracking result (no keyframe products). The local-map
    association stays on the device; it feeds keyframe_step when the host
    promotes the frame."""

    R: torch.Tensor
    t: torch.Tensor
    vel: torch.Tensor
    stats: torch.Tensor      # [22], same layout as TrackOut.stats
    ml_idx_a: torch.Tensor   # [M] int32 local-map slot
    ml_idx_b: torch.Tensor   # [M] int32 current keypoint
    ml_gated: torch.Tensor   # [M] bool valid & projection-gated
    ml_inlier: torch.Tensor  # [M] bool PnP inlier
    ml_x: torch.Tensor       # [M, 2] normalized observation
    ok: torch.Tensor         # [] bool tracking accepted


def _take(x: torch.Tensor, i) -> torch.Tensor:
    """x[i] along the first axis: a view for a Python int; for a 0-d
    device index a copy through index_select (x[i] would read i to the
    host, a sync a graph cannot hold). uint32 rows (ORB's bit-packed
    descriptors) go through an int32 view: torch has no index_select for
    uint32."""
    if not torch.is_tensor(i):
        return x[i]
    if x.dtype == torch.uint32:
        return _take(x.view(torch.int32), i).view(torch.uint32)
    return x.index_select(0, i.reshape(1).long())[0]


def _index(tree, i):
    """tree (nested NamedTuples of tensors) with every leaf indexed by i
    along its first axis."""
    if isinstance(tree, tuple):
        return type(tree)(*(_index(x, i) for x in tree))
    return _take(tree, i)


def index_features(fb: Features, i) -> Features:
    """Frame i of batched Features: views for a Python int i, copies for a
    0-d device index (no host sync)."""
    return _index(fb, i)


def lite_at(batch_lite: TrackLite, i) -> TrackLite:
    """Frame i's TrackLite from a track_batch result (i as in
    index_features)."""
    return _index(batch_lite, i)


def _local_map_features(lmap: LocalMap) -> Features:
    kps = Keypoints.empty(lmap.desc.shape[0], lmap.desc.device)
    return Features(kps._replace(valid=lmap.valid), lmap.desc)


def track_step_lite(lmap: LocalMap, feats: Features, state: TrackState,
                    intr: torch.Tensor, cfg: SlamConfig, min_inliers: int,
                    kernels: Kernels = KERNELS) -> TrackLite:
    """Every-frame tracking: local-map 3D-2D association + motion-only PnP
    + constant-velocity update. min_inliers: PnP inliers below which the
    frame keeps the constant-velocity prediction. Float32 matmuls (TF32
    off), as the reference."""
    f32_matmul()
    # ---- 1. local-map 3D-2D association ------------------------------
    ml = match_features(_local_map_features(lmap), feats, cfg.match, kernels)
    x_l = normalized(feats.keypoints.yx[ml.idx_b.long()].flip(-1), intr)
    Xw_l = lmap.X[ml.idx_a.long()]                       # [Ml, 3]

    # ---- 2. constant-velocity prediction + motion-only LM ------------
    dR, dt = se3.se3_exp(state.vel)
    R0 = dR @ state.R
    t0 = dR @ state.t + dt
    # spatial gate: a descriptor match counts only if the landmark projects
    # near the keypoint under the predicted pose
    Xc_l = Xw_l @ R0.T + t0
    z_l = Xc_l[:, 2]
    proj_l = Xc_l[:, :2] / torch.clamp_min(z_l[:, None], 1e-6)
    gate = (z_l > 1e-3) & (torch.linalg.vector_norm(proj_l - x_l, dim=-1)
                           < cfg.track_gate)
    ml_gated = ml.valid & gate
    pr = refine_pose(R0, t0, Xw_l, x_l, ml_gated)
    ok = pr.num_inliers >= min_inliers
    R = torch.where(ok, pr.R, R0)
    t = torch.where(ok, pr.t, t0)

    # ---- 3. velocity update: vel = log(T_new . T_old^-1) -------------
    Rrel, trel = se3.compose(R, t, *se3.inverse(state.R, state.t))
    vel = torch.where(ok, se3.se3_log(Rrel, trel), state.vel)

    n_gated = ml_gated.sum().to(torch.float32)
    stats = torch.cat([
        torch.stack([n_gated, pr.num_inliers.to(torch.float32), pr.cost,
                     n_gated]),
        R.reshape(-1), t, vel])
    return TrackLite(R=R, t=t, vel=vel, stats=stats,
                     ml_idx_a=ml.idx_a, ml_idx_b=ml.idx_b,
                     ml_gated=ml_gated, ml_inlier=pr.inliers, ml_x=x_l,
                     ok=ok)


def keyframe_step(kf: KeyframeRef, feats: Features, lite: TrackLite,
                  intr: torch.Tensor, cfg: SlamConfig, max_depth: float,
                  kernels: Kernels = KERNELS) -> TrackOut:
    """Keyframe products for a frame already tracked by track_step_lite:
    2D-2D match vs the last keyframe + DLT triangulation + acceptance
    gates for new landmarks. max_depth: new landmarks beyond this depth
    (in the keyframe's camera frame) are rejected. Float32 matmuls (TF32
    off), as the reference."""
    f32_matmul()
    R, t = lite.R, lite.t
    kf_kps = Keypoints.empty(kf.desc.shape[0], kf.desc.device)
    kf_feats = Features(kf_kps._replace(yx=kf.yx, valid=kf.kp_valid), kf.desc)
    m = match_features(kf_feats, feats, cfg.match, kernels)
    ia, ib = m.idx_a.long(), m.idx_b.long()
    x1 = normalized(kf.yx[ia].flip(-1), intr)
    x2 = normalized(feats.keypoints.yx[ib].flip(-1), intr)
    # relative pose keyframe -> current
    Rrel2, trel2 = se3.compose(R, t, *se3.inverse(kf.R, kf.t))
    Xc1 = triangulate(Rrel2, trel2, x1, x2, kernels)    # keyframe cam frame
    Xw = (Xc1 - kf.t) @ kf.R                            # world
    z1 = Xc1[:, 2]
    Xc2 = Xw @ R.T + t
    z2 = Xc2[:, 2]
    r1 = torch.linalg.vector_norm(
        Xc1[:, :2] / torch.clamp_min(z1[:, None], 1e-6) - x1, dim=1)
    r2 = torch.linalg.vector_norm(
        Xc2[:, :2] / torch.clamp_min(z2[:, None], 1e-6) - x2, dim=1)
    # current keypoints already associated to a landmark this frame must not
    # spawn duplicates
    tracked = (lite.ml_gated & lite.ml_inlier).to(torch.int32)
    assoc = torch.zeros(feats.capacity, dtype=torch.int32,
                        device=tracked.device).scatter_reduce(
        0, lite.ml_idx_b.long(), tracked, "amax") > 0
    fresh = ~kf.kp_has_lm[ia] & ~assoc[ib]
    tri_good = (m.valid & fresh & lite.ok
                & (z1 > 1e-3) & (z2 > 1e-3) & (z1 < max_depth)
                & (r1 < 6e-3) & (r2 < 6e-3))

    stats = torch.cat([m.count().to(torch.float32)[None], lite.stats[1:]])
    i32 = torch.int32
    assoc_i = torch.stack([
        lite.ml_idx_a, lite.ml_idx_b,
        lite.ml_gated.to(i32) | (lite.ml_inlier.to(i32) << 1),
        m.idx_a, m.idx_b,
        m.valid.to(i32) | (tri_good.to(i32) << 1),
    ], 1)
    assoc_f = torch.cat([lite.ml_x, x1, x2, Xw], 1)
    return TrackOut(R=R, t=t, vel=lite.vel, stats=stats,
                    assoc_i=assoc_i, assoc_f=assoc_f)


def track_batch(lmap: LocalMap, feats_b: Features, start,
                state: TrackState, intr: torch.Tensor, cfg: SlamConfig,
                min_inliers: int, kernels: Kernels = KERNELS):
    """Track every frame of a detected batch, the pose state chained on the
    device (the JAX package's lax.scan, as a Python loop).

    Frames with index < start (an int or a 0-d tensor) pass the state
    through unchanged (zeroed stats): a mid-batch restart reruns the batch
    with a new start. Returns (final TrackState, TrackLite of the batch:
    every leaf gains a leading [B] axis)."""
    B = feats_b.keypoints.yx.shape[0]
    active_all = torch.arange(B, device=feats_b.descriptors.device) >= start
    st, outs = state, []
    for i in range(B):
        lite = track_step_lite(lmap, index_features(feats_b, i), st, intr,
                               cfg, min_inliers, kernels)
        active = active_all[i]
        st = TrackState(*(torch.where(active, a, b)
                          for a, b in zip(lite[:3], st)))
        outs.append(TrackLite(
            R=st.R, t=st.t, vel=st.vel,
            stats=torch.where(active, lite.stats, 0.0),
            ml_idx_a=lite.ml_idx_a, ml_idx_b=lite.ml_idx_b,
            ml_gated=lite.ml_gated & active,
            ml_inlier=lite.ml_inlier & active,
            ml_x=lite.ml_x,
            ok=lite.ok & active))
    return st, TrackLite(*(torch.stack(f) for f in zip(*outs)))


def pack_keyframe_products(full: TrackOut, feats: Features) -> torch.Tensor:
    """Pack every scalar/index/coordinate a keyframe promotion reads back
    into ONE float32 tensor (one device-to-host copy).

    Layout: [22 stats][M*6 assoc_i][M*9 assoc_f][K*2 yx][K response]
    [K valid]. assoc_i values are indices < 2^24 and 2-bit flags, exactly
    representable in f32."""
    kp = feats.keypoints
    return torch.cat([
        full.stats,
        full.assoc_i.to(torch.float32).reshape(-1),
        full.assoc_f.reshape(-1),
        kp.yx.reshape(-1),
        kp.response,
        kp.valid.to(torch.float32),
    ])


def unpack_keyframe_products(packed, M: int, K: int):
    """Host-side inverse of pack_keyframe_products (numpy array or tensor).
    Returns (stats[22], assoc_i[M,6] int, assoc_f[M,9], yx[K,2],
    response[K], valid[K] bool) as numpy."""
    a = (packed.cpu().numpy() if isinstance(packed, torch.Tensor)
         else np.asarray(packed))
    o = 22
    stats = a[:o]
    ai = a[o:o + M * 6].reshape(M, 6).astype(np.int64)
    o += M * 6
    af = a[o:o + M * 9].reshape(M, 9)
    o += M * 9
    yx = a[o:o + K * 2].reshape(K, 2)
    o += K * 2
    resp = a[o:o + K]
    o += K
    valid = a[o:o + K] > 0.5
    return stats, ai, af, yx, resp, valid


def track_step(kf: KeyframeRef, lmap: LocalMap, feats: Features,
               state: TrackState, intr: torch.Tensor, cfg: SlamConfig,
               min_inliers: int, max_depth: float,
               kernels: Kernels = KERNELS) -> TrackOut:
    """One frame of tracking with its keyframe products: track_step_lite
    then keyframe_step."""
    lite = track_step_lite(lmap, feats, state, intr, cfg, min_inliers,
                           kernels)
    return keyframe_step(kf, feats, lite, intr, cfg, max_depth, kernels)


def _track_step(x: tuple, cfg: tuple) -> TrackOut:
    """x = (kf, lmap, feats, state, intr); cfg = ((SlamConfig, min_inliers,
    max_depth), Kernels)."""
    (scfg, min_inliers, max_depth), kernels = cfg
    return track_step(*x, scfg, min_inliers, max_depth, kernels)


_TRACK_STEP = GraphProgram(_track_step, seeded=False)


def track_step_jit(kf: KeyframeRef, lmap: LocalMap, feats: Features,
                   state: TrackState, intr: torch.Tensor, cfg: SlamConfig,
                   min_inliers: int, max_depth: float,
                   kernels: Kernels = KERNELS) -> TrackOut:
    """track_step as one captured graph per shape key and (cfg,
    min_inliers, max_depth, kernels): the JAX package's `track_step_jit`.
    The result is the caller's (copies of the graph's outputs)."""
    return _TRACK_STEP((kf, lmap, feats, state, intr),
                       ((cfg, min_inliers, max_depth), kernels))


track_step_jit.program = _TRACK_STEP


def build_local_map(slam_map, capacity: int, desc_dim: int, desc_dtype,
                    device="cuda") -> tuple[LocalMap, np.ndarray]:
    """Host-side rebuild of the covisible-landmark set from the sliding
    window. For each landmark observed in the window, take the descriptor of
    its MOST RECENT observing keyframe. Returns (LocalMap on `device`,
    global landmark ids [Kl] numpy, -1 for empty slots)."""
    desc = np.zeros((capacity, desc_dim), desc_dtype)
    X = np.zeros((capacity, 3), np.float32)
    ids = np.full(capacity, -1, np.int64)
    n = 0
    claimed = np.zeros(slam_map.max_landmarks, bool)
    for s in reversed(slam_map.kf_order):            # newest first
        kp_lm = slam_map.kf_kp_lm[s]
        if slam_map.kf_desc[s] is None:
            continue
        sel = np.nonzero(kp_lm >= 0)[0]
        if sel.size == 0:
            continue
        lms = kp_lm[sel]
        keep = slam_map.lm_valid[lms] & ~claimed[lms]
        sel, lms = sel[keep], lms[keep]
        # first occurrence per landmark within this keyframe
        lms, first = np.unique(lms, return_index=True)
        sel = sel[first]
        claimed[lms] = True
        take = min(len(lms), capacity - n)
        d_s = np.asarray(slam_map.kf_desc[s])
        desc[n:n + take] = d_s[sel[:take]]
        ids[n:n + take] = lms[:take]
        n += take
        if n >= capacity:
            break
    live = ids >= 0
    X[live] = slam_map.X[ids[live]]
    lmap = LocalMap(desc=torch.from_numpy(desc).to(device),
                    X=torch.from_numpy(X).to(device),
                    valid=torch.from_numpy(live).to(device))
    return lmap, ids

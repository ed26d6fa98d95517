"""Device-resident SLAM engine: a whole frame batch as one device program
(visualslam_tpu/slam/engine.py).

Per frame `track_step_lite` (local-map match + PnP + velocity model); on a
promotion, still inside the batch:

  * windowed bundle adjustment over the device-resident observation grid
    (refines the window poses and landmark positions before the new
    keyframe's triangulation gates run), with the scale-gauge re-anchor;
  * the current pose re-refined against the adjusted local map;
  * 2D-2D match vs the last keyframe + triangulation gates
    (slam/track_step.keyframe_step);
  * local-map maintenance + keyframe-reference swap;
  * window-ring append + observation-grid update;
  * loop database append, retrieval (cosine matvec) + geometric
    verification + Sim(3) relative-scale estimate.

Everything the tracker needs between batches chains device to device in
`EnginePersist`; the per-batch host input `EngineDyn` is the frame counter
base, the active frame range and a landmark kill list; the result reads
back as one packed float32 buffer with exactly the JAX package's layout, so
its `decode_packed` reads the port's buffer.

Where the JAX package scans with `lax.scan` and branches with
`lax.cond(need_kf, _promote, ...)`, the port splits the scan's body in two
functions with no host read: `engine_step` (one frame's tracking and
keyframe decision) and `engine_promote` (the promotion). Every value the
body needs of the batch is a device tensor: the frame index and counter,
the promotion count (the record is a "drop" write at that row), the stats
rows ([B, 24]) and the frame's features (gathered by a device index). A
driver runs engine_step on each active frame [start, stop), reads its
`need` to the host (`.item()`, one host sync per active frame) and runs
engine_promote where it is set: `run_engine_batch` does so eagerly (the
CPU, and the card's reference), `engine_programs` (`EngineProgram`) from
CUDA graphs captured once per shape, the PyTorch counterpart of the JAX
package's compiled programs. Every other choice is a `torch.where`;
`mode="drop"` scatters write into a copy with one trash row. Neither driver
updates the caller's persist in place: the loop database is copied once
per batch and the promotions append to that copy, so a batch can be re-run
from the same state.

Capacities: K feature slots, Kl local-map slots, M match slots, W window
cameras (cfg.ba.max_cameras), Ks loop subsample, CAP loop-database
entries, P = max promotions per batch.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from visualslam_tpu_torch.backend.ba import BAProblem, run_ba
from visualslam_tpu_torch.backend.pnp import refine_pose
from visualslam_tpu_torch.geometry.camera import normalized
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels, triangulate
from visualslam_tpu_torch.ops.distance import unpack_bits
from visualslam_tpu_torch.slam.track_step import (
    KeyframeRef,
    LocalMap,
    TrackLite,
    TrackState,
    build_local_map,
    index_features,
    keyframe_step,
    track_step_lite,
)
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.graphs import (
    GraphProgram,
    _assign,
    _Capture,
    _clone_all,
    _copy_all,
    _leaves,
    _map,
    _signature,
    _static,
    _Uncaptured,
)
from visualslam_tpu_torch.utils.masked import top_k
from visualslam_tpu_torch.utils.precision import f32_matmul
from visualslam_tpu_torch.utils.profiling import span

NC = 3          # loop retrieval candidates verified per promotion
LOOP_REC = 22   # per-candidate verify record:
#                 [cand, sim, usable, inl, R(9), t(3), scale, nboth,
#                  recip_inl, rot_consist_deg, trans_consist,
#                  baseline_frac]
HDR = 8         # promotion record header floats
_I32 = torch.int32
_F32 = torch.float32


class EnginePersist(NamedTuple):
    """Device state that lives across batches. Shapes: K = feature
    capacity, Df = float descriptor dim, Kl = local-map slots, W = window
    cameras, Ks = loop subsample, N = CAP."""

    # chained tracking state
    R: torch.Tensor           # [3, 3] world-to-camera pose state
    t: torch.Tensor           # [3]
    vel: torch.Tensor         # [6] constant-velocity twist
    since_kf: torch.Tensor    # [] int32 frames since last keyframe
    # last-keyframe reference (2D-2D match source)
    kf_desc: torch.Tensor     # [K, D]
    kf_yx: torch.Tensor       # [K, 2]
    kf_valid: torch.Tensor    # [K] bool
    kf_has_lm: torch.Tensor   # [K] bool
    kf_R: torch.Tensor        # [3, 3]
    kf_t: torch.Tensor        # [3]
    # local map
    lm_desc: torch.Tensor     # [Kl, D]
    lm_X: torch.Tensor        # [Kl, 3] world positions (window-BA refined)
    lm_valid: torch.Tensor    # [Kl] bool
    lm_last: torch.Tensor     # [Kl] int32 frame counter of last association
    lm_gen: torch.Tensor      # [Kl] int32 allocation generation per slot
    # keyframe window ring (left-aligned: oldest at 0) + observation grid
    win_R: torch.Tensor       # [W, 3, 3]
    win_t: torch.Tensor       # [W, 3]
    win_valid: torch.Tensor   # [W] bool
    win_fid: torch.Tensor     # [W] int32 global frame id per window cam
    win_n: torch.Tensor       # [] int32 live window size
    obs_x: torch.Tensor       # [Kl, W, 2] normalized observations
    obs_ok: torch.Tensor      # [Kl, W] bool
    ba_cost: torch.Tensor     # [] f32 last in-batch window-BA cost (-1 none)
    # loop database ring
    db_n: torch.Tensor        # [] int32 live entries
    db_g: torch.Tensor        # [N, Df] global descriptors (L2-normalized)
    db_desc: torch.Tensor     # [N, Ks, Df]
    db_yx: torch.Tensor       # [N, Ks, 2]
    db_lmw: torch.Tensor      # [N, Ks, 3] landmark snapshot per sub keypoint
    db_haslm: torch.Tensor    # [N, Ks] bool
    db_R: torch.Tensor        # [N, 3, 3] entry poses (pose-graph corrected)
    db_t: torch.Tensor        # [N, 3]


_DB_FIELDS = ("db_g", "db_desc", "db_yx", "db_lmw", "db_haslm", "db_R",
              "db_t")


class EngineDyn(NamedTuple):
    """Per-batch host input. frame_base, start and stop are host ints (the
    driver knows them); frames [start, stop) are active."""

    frame_base: int           # global index of batch frame 0
    start: int                # first active frame in the batch
    stop: int                 # first inactive frame (padded tail batches)
    kill: torch.Tensor        # [Kl] bool host-invalidated slots
    kill_gen: torch.Tensor    # [Kl] int32 generation the kill refers to


def engine_dyn(frame_base: int, start: int, stop: int, Kl: int,
               device="cuda") -> EngineDyn:
    """EngineDyn with an empty kill list, on `device`."""
    return EngineDyn(frame_base=frame_base, start=start, stop=stop,
                     kill=torch.zeros(Kl, dtype=torch.bool, device=device),
                     kill_gen=torch.zeros(Kl, dtype=_I32, device=device))


class _Carry(NamedTuple):
    """A batch in flight, all on the device."""

    p: EnginePersist
    prom_n: torch.Tensor      # [] int32 promotions so far in this batch
    prom_buf: torch.Tensor    # [P, prom_record_size(M)]
    stats: torch.Tensor       # [B, 24] per-frame stats rows


def float_desc(desc: torch.Tensor) -> torch.Tensor:
    """Descriptors as floats: bit-packed uint32 words unpack to {0, 1} in
    the bit order of np.unpackbits(view(uint8), bitorder='little')
    (ops/distance.unpack_bits)."""
    if desc.dtype == torch.uint32:
        return unpack_bits(desc)
    return desc.to(_F32)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[idx] along the first axis; bit-packed uint32 rows through an int32
    view (torch has no indexing kernel for uint32 on the card in some
    releases)."""
    if x.dtype == torch.uint32:
        return x.view(torch.int32)[idx].view(torch.uint32)
    return x[idx]


def float_desc_dim(desc_dim: int, dtype) -> int:
    u32 = (dtype == torch.uint32 if isinstance(dtype, torch.dtype)
           else np.dtype(dtype) == np.uint32)
    return desc_dim * 32 if u32 else desc_dim


def prom_record_size(M: int) -> int:
    return HDR + M * 7 + M * 9 + NC * LOOP_REC


def tail_size(W: int, Kl: int) -> int:
    """Floats in the per-batch telemetry tail: window poses/ids/validity +
    landmark positions/validity + the window-BA cost."""
    return W * (9 + 3 + 1 + 1) + Kl * (3 + 1) + 1


def _sub_match_cfg(cfg: SlamConfig):
    return cfg.match.replace(max_matches=cfg.loop.sub_keypoints,
                             metric="l2", impl="xla")


# ---------------------------------------------------------------------
# indexing helpers: JAX's .at[...] forms without host syncs
# ---------------------------------------------------------------------


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-d device index (x[i] itself would read i to the host)."""
    return x.index_select(0, i.reshape(1).long())[0]


def _on_device(x: torch.Tensor, val):
    """val as a tensor on x's device: a Python scalar becomes a device fill
    (indexed assignment of a Python scalar copies it from the host, one
    host sync)."""
    return val if torch.is_tensor(val) else x.new_full((), val)


def _set_drop(x: torch.Tensor, idx: torch.Tensor, val) -> torch.Tensor:
    """x.at[idx].set(val, mode="drop") for idx in [0, len(x)]: the write
    goes to a copy with one trash row at index len(x), then sliced off.
    Bit-packed uint32 rows are written through an int32 view (torch has no
    index_put for uint32)."""
    if x.dtype == torch.uint32:
        val = _on_device(x, val).view(torch.int32)
        return _set_drop(x.view(torch.int32), idx, val).view(torch.uint32)
    buf = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    buf[idx.long()] = _on_device(x, val)
    return buf[:x.shape[0]]


def _set2_drop(x: torch.Tensor, rows: torch.Tensor, col: torch.Tensor,
               val) -> torch.Tensor:
    """x.at[rows, col].set(val, mode="drop") for x [n, W, ...], rows in
    [0, n] (n drops) and a 0-d device column."""
    n, W = x.shape[:2]
    buf = torch.cat([x, x.new_zeros((1,) + x.shape[1:])])
    buf.view((n + 1) * W, *x.shape[2:])[rows.long() * W + col.long()] = (
        _on_device(x, val))
    return buf[:n]


def _ring_write(buf: torch.Tensor, wr: torch.Tensor, val) -> None:
    """buf[wr] = val IN PLACE where wr < len(buf), else nothing (the JAX
    mode="drop" append); buf is run_engine_batch's own copy."""
    cap = buf.shape[0]
    i = wr.clamp(max=cap - 1).long().reshape(1)
    keep = buf.index_select(0, i)[0]
    buf.index_copy_(0, i, torch.where(wr < cap, val, keep)[None])


# ---------------------------------------------------------------------
# device program
# ---------------------------------------------------------------------


def _window_ba(p: EnginePersist, cfg: SlamConfig):
    """Bundle-adjust the device-resident window: cameras = the keyframe
    ring, landmarks = local-map slots with >= 2 grid observations, the
    dense Schur solver on the fixed [Kl, W] observation grid. Returns
    (win_R, win_t, lm_X, cost)."""
    W = p.win_R.shape[0]
    Kl = p.lm_X.shape[0]
    dev = p.lm_X.device
    obs_n = (p.obs_ok & p.win_valid[None, :]).sum(1)                # [Kl]
    lm_ba = p.lm_valid & (obs_n >= 2)
    cam_idx = torch.arange(W, dtype=_I32, device=dev)[None, :].expand(
        Kl, W).reshape(-1)
    lm_idx = torch.arange(Kl, dtype=_I32, device=dev)[:, None].expand(
        Kl, W).reshape(-1)
    ov = (p.obs_ok & lm_ba[:, None] & p.win_valid[None, :]).reshape(-1)
    prob = BAProblem(
        R=p.win_R, t=p.win_t, X=p.lm_X, cam_idx=cam_idx, lm_idx=lm_idx,
        uv=p.obs_x.reshape(-1, 2), obs_valid=ov,
        cam_valid=p.win_valid, lm_valid=lm_ba)
    # fix_first_camera anchors window index 0, the oldest keyframe; the
    # window is small, so the dense Schur solve serves even when the config
    # selects the matrix-free solver for sequence-scale problems
    ba_cfg = (cfg.ba.replace(solver="schur_dense")
              if cfg.ba.solver == "schur_mf" else cfg.ba)
    res = run_ba(prob, ba_cfg)
    R_n, t_n, X_n = res.R, res.t, res.X
    if cfg.ba.fix_gauge_scale:
        # monocular BA leaves the global scale free: re-anchor by a
        # similarity about camera 0's centre so that the baseline to the
        # newest valid camera keeps its pre-solve length
        last = (p.win_n.clamp(max=W) - 1).clamp(0, W - 1)

        def center(R, t):
            return -torch.einsum("...ji,...j->...i", R, t)

        c0 = center(R_n[0], t_n[0])
        d_old = torch.linalg.vector_norm(
            center(_row(p.win_R, last), _row(p.win_t, last))
            - center(p.win_R[0], p.win_t[0]))
        d_new = torch.linalg.vector_norm(
            center(_row(R_n, last), _row(t_n, last)) - c0)
        s = torch.where((d_new > 1e-8) & (d_old > 1e-8), d_old / d_new,
                        torch.ones_like(d_new)).clamp(0.5, 2.0)
        c_scaled = c0 + s * (center(R_n, t_n) - c0)                # [W, 3]
        t_n = -torch.einsum("wij,wj->wi", R_n, c_scaled)
        X_n = c0 + s * (X_n - c0)
    X = torch.where(lm_ba[:, None], X_n, p.lm_X)
    return R_n, t_n, X, res.cost


def _verify_candidate(a_desc, a_yx, a_haslm, a_lmw,
                      b_desc, b_yx, b_haslm, b_lmw, b_R, b_t,
                      intr, sub_cfg, estimate_scale: bool,
                      a_R=None, a_t=None) -> torch.Tensor:
    """Geometric loop verification: descriptor match + motion-only PnP of
    the candidate camera against the current keyframe's landmark snapshot
    (coarse wide-Huber stage, then fine), plus the Sim(3) relative-scale
    estimate (median pairwise-distance ratio over landmark pairs with 3D in
    both keyframes, trusted only with strong support and a tight spread).

    With (a_R, a_t) the verification is mutual: the current camera is also
    PnP'd against the candidate's landmark snapshot, and the two measured
    relative poses are compared (rotation agreement, translation
    disagreement and baseline over the median scene depth). Returns the
    [20] record [usable, inliers, R(9), t(3), scale, nboth, recip_inl,
    rot_consist_deg, trans_consist, baseline_frac]."""
    ks = a_desc.shape[0]
    dev = a_desc.device
    ones = torch.ones(ks, dtype=torch.bool, device=dev)
    empty = Keypoints.empty(ks, dev)
    fa = Features(empty._replace(yx=a_yx, valid=ones), a_desc)
    fb = Features(empty._replace(yx=b_yx, valid=ones), b_desc)
    m = match_features(fa, fb, sub_cfg)
    ia, ib = m.idx_a.long(), m.idx_b.long()
    usable = m.valid & a_haslm[ia]
    X = a_lmw[ia]
    x_b = normalized(b_yx[ib].flip(-1), intr)
    pr0 = refine_pose(b_R, b_t, X, x_b, usable, iters=12, huber_delta=5e-2)
    pr = refine_pose(pr0.R, pr0.t, X, x_b, usable, iters=15)

    zero = torch.zeros((), dtype=_F32, device=dev)
    recip_inl = rot_consist = trans_consist = baseline_frac = zero
    if a_R is not None:
        usable_b = m.valid & b_haslm[ib]
        Xb = b_lmw[ib]
        x_a = normalized(a_yx[ia].flip(-1), intr)
        pr20 = refine_pose(b_R, b_t, Xb, x_a, usable_b, iters=12,
                           huber_delta=5e-2)
        pr2 = refine_pose(pr20.R, pr20.t, Xb, x_a, usable_b, iters=15)
        recip_inl = pr2.num_inliers.to(_F32)
        rel_cur = a_R @ pr.R.T
        rel_old = pr2.R @ b_R.T
        cosang = (torch.trace(rel_cur.T @ rel_old) - 1.0) / 2.0
        rot_consist = torch.rad2deg(torch.arccos(cosang.clamp(-1.0, 1.0)))
        c_a1 = -a_R.T @ a_t
        c_b1 = -pr.R.T @ pr.t
        c_a2 = -pr2.R.T @ pr2.t
        c_b2 = -b_R.T @ b_t
        u1 = pr.R @ (c_a1 - c_b1)
        u2 = b_R @ (c_a2 - c_b2)
        z = (X @ pr.R.T)[:, 2] + pr.t[2]
        zs = torch.sort(torch.where(usable, z, torch.full_like(z, np.inf)))[0]
        n_us = usable.sum(dtype=_I32)
        med_z = _row(zs, (n_us - 1).clamp_min(0) // 2)
        med_z = torch.where((n_us > 0) & (med_z > 1e-3), med_z,
                            torch.full_like(med_z, 1e9))
        trans_consist = torch.linalg.vector_norm(u1 - u2) / med_z
        baseline_frac = torch.maximum(
            torch.linalg.vector_norm(c_a1 - c_b1),
            torch.linalg.vector_norm(c_a1 - c_b2)) / med_z

    scale = torch.ones((), dtype=_F32, device=dev)
    nboth = torch.zeros((), dtype=_I32, device=dev)
    if estimate_scale:
        both = pr.inliers & usable & b_haslm[ib]
        NS = 32
        # up to NS matched pairs with 3D on both sides (stable partition)
        sel = torch.sort((~both).to(_I32), stable=True)[1][:NS]
        ok = both[sel]
        Xa = a_lmw[ia[sel]]
        Xb = b_lmw[ib[sel]]
        da = torch.linalg.vector_norm(Xa[:, None] - Xa[None, :], dim=-1)
        db = torch.linalg.vector_norm(Xb[:, None] - Xb[None, :], dim=-1)
        n = sel.shape[0]
        iu = torch.ones((n, n), dtype=torch.bool, device=dev).triu(1)
        pair_ok = (ok[:, None] & ok[None, :] & iu & (da > 1e-6)
                   & (db > 1e-6))
        ratio = db / da.clamp_min(1e-6)
        vals = torch.sort(torch.where(pair_ok, ratio,
                                      torch.full_like(ratio, np.inf))
                          .reshape(-1))[0]
        n_ok = pair_ok.sum(dtype=_I32)
        nmax = (n_ok - 1).clamp_min(0)
        med = _row(vals, nmax // 2)                          # lower median
        q1 = _row(vals, nmax // 4)
        q3 = _row(vals, (3 * nmax) // 4)
        nboth = ok.sum(dtype=_I32)
        spread_ok = (q3 - q1) <= 0.1 * med.clamp_min(1e-6)
        scale = torch.where((n_ok >= 45) & (nboth >= 10) & spread_ok,
                            med.clamp(0.2, 5.0), scale)

    return torch.cat([
        torch.stack([usable.sum().to(_F32), pr.num_inliers.to(_F32)]),
        pr.R.reshape(-1), pr.t,
        torch.stack([scale, nboth.to(_F32), recip_inl, rot_consist,
                     trans_consist, baseline_frac]),
    ])


def _global_desc(feats: Features):
    """(float descriptors [K, Df], response-weighted L2-normalized global
    descriptor [Df]) of one frame."""
    descF = float_desc(feats.descriptors)
    kp = feats.keypoints
    w = torch.where(kp.valid, kp.response.clamp_min(1e-6),
                    torch.zeros_like(kp.response))
    g = (descF * w[:, None]).sum(0)
    return descF, g / torch.linalg.vector_norm(g).clamp_min(1e-9)


class StepOut(NamedTuple):
    """What `engine_step` hands to `engine_promote` for its frame."""

    feats: Features          # the frame's features
    lite: TrackLite          # its tracking result
    need: torch.Tensor       # [] bool: promote it (prom_n < P included)


def frame_features(feats_b: Features, i: torch.Tensor) -> Features:
    """Frame i of batched Features for a 0-d device index (a copy; indexing
    by a tensor would read i to the host): track_step.index_features."""
    return index_features(feats_b, i)


def _set_row(stats: torch.Tensor, i: torch.Tensor,
             row: torch.Tensor) -> torch.Tensor:
    """stats with row i replaced (a copy)."""
    return stats.index_copy(0, i.reshape(1).long(), row[None])


def _stats_row(lite: TrackLite, R, t, vel, promoted: float) -> torch.Tensor:
    """A frame's [24] stats row: the track_step_lite stats [0:4], the pose
    and velocity after the frame, [promoted, 0]."""
    flags = lite.stats.new_zeros(2)
    if promoted:
        flags = torch.cat([lite.stats.new_ones(1), lite.stats.new_zeros(1)])
    return torch.cat([lite.stats[:4], R.reshape(-1), t, vel, flags])


def engine_enter(persist: EnginePersist, kill: torch.Tensor,
                 kill_gen: torch.Tensor, B: int, P: int, M: int) -> _Carry:
    """A batch's starting carry: the host-side invalidations (lag-1) applied
    where the generation matches, no promotion yet."""
    dev = persist.R.device
    kill = kill & (kill_gen == persist.lm_gen)
    return _Carry(
        p=persist._replace(lm_valid=persist.lm_valid & ~kill),
        prom_n=torch.zeros((), dtype=_I32, device=dev),
        prom_buf=torch.zeros((P, prom_record_size(M)), dtype=_F32,
                             device=dev),
        stats=torch.zeros((B, 24), dtype=_F32, device=dev))


def engine_step(c: _Carry, feats_b: Features, i: torch.Tensor,
                frame_base: torch.Tensor, intr: torch.Tensor,
                cfg: SlamConfig, ok_min: int, P: int,
                kernels: Kernels = KERNELS) -> tuple[_Carry, StepOut]:
    """Track active frame i (a 0-d int32 device index) of the batch:
    track_step_lite against the device local map, the landmarks' last
    association, frames since the keyframe, the keyframe decision and the
    frame's stats row. No host read: the caller reads `need` to decide on
    `engine_promote`."""
    p = c.p
    feats = frame_features(feats_b, i)
    lmap = LocalMap(desc=p.lm_desc, X=p.lm_X, valid=p.lm_valid)
    lite = track_step_lite(lmap, feats, TrackState(p.R, p.t, p.vel), intr,
                           cfg, ok_min, kernels)
    fctr = frame_base + i
    seen = lite.ml_gated & lite.ml_inlier
    Kl = p.lm_last.shape[0]
    hit = _set_drop(torch.zeros_like(p.lm_valid),
                    torch.where(seen, lite.ml_idx_a.long(),
                                torch.full_like(lite.ml_idx_a, Kl,
                                                dtype=torch.int64)),
                    True)
    lm_last = torch.where(hit, fctr, p.lm_last)
    since = p.since_kf + 1
    inl = lite.stats[1]
    need = (lite.ok & (since >= cfg.keyframe_min_gap)
            & ((inl < cfg.keyframe_min_inliers)
               | (since >= cfg.keyframe_max_gap))
            & (c.prom_n < P))
    p = p._replace(R=lite.R, t=lite.t, vel=lite.vel, lm_last=lm_last,
                   since_kf=torch.where(need, 0, since))
    stats = _set_row(c.stats, i, _stats_row(lite, lite.R, lite.t, lite.vel,
                                            0.0))
    return c._replace(p=p, stats=stats), StepOut(feats, lite, need)


def engine_promote(c: _Carry, step: StepOut, i: torch.Tensor,
                   frame_base: torch.Tensor, intr: torch.Tensor,
                   cfg: SlamConfig, max_depth: float, P: int, ok_min: int,
                   kernels: Kernels = KERNELS) -> _Carry:
    """The in-batch keyframe promotion of frame i, in the reference's
    order (no host read):

      1. window BA over the device observation grid
      2. re-refine the current frame's pose against the adjusted local map
      3. 2D-2D match vs the (refined) last keyframe + triangulation gates
      4. local-map maintenance, keyframe-reference swap, window append +
         observation-grid update
      5. loop database entry + retrieval + verification

    The promotion record goes to row prom_n of the batch's buffer and the
    frame's stats row is rewritten with the refined pose. The loop
    database is appended IN PLACE: c.p's database is the batch's own."""
    p = c.p
    feats, lite = step.feats, step.lite
    fctr = frame_base + i
    K = feats.capacity
    Kl = p.lm_desc.shape[0]
    Ks = cfg.loop.sub_keypoints
    CAP = p.db_g.shape[0]
    W = p.win_R.shape[0]
    dev = p.R.device

    # ---- 1. window BA (pre-promotion window) -------------------------
    win_R, win_t, lm_X, ba_cost = _window_ba(p, cfg)
    last_idx = (p.win_n.clamp(max=W) - 1).clamp(0, W - 1)
    kf_R = _row(win_R, last_idx)
    kf_t = _row(win_t, last_idx)

    # ---- 2. re-refine the current pose vs the adjusted map -----------
    ia_l = lite.ml_idx_a.long()
    pr2 = refine_pose(lite.R, lite.t, lm_X[ia_l], lite.ml_x, lite.ml_gated)
    ok2 = pr2.num_inliers >= ok_min
    R_cur = torch.where(ok2, pr2.R, lite.R)
    t_cur = torch.where(ok2, pr2.t, lite.t)
    inliers = torch.where(ok2, pr2.inliers, lite.ml_inlier)
    lite = lite._replace(R=R_cur, t=t_cur, ml_inlier=inliers)

    # ---- 3. keyframe products (2D-2D match + triangulation) ----------
    kfref = KeyframeRef(desc=p.kf_desc, yx=p.kf_yx, kp_valid=p.kf_valid,
                        kp_has_lm=p.kf_has_lm, R=kf_R, t=kf_t)
    full = keyframe_step(kfref, feats, lite, intr, cfg, max_depth, kernels)
    m_idx_b = full.assoc_i[:, 4].long()
    tri_good = (full.assoc_i[:, 5] & 2) > 0
    Xw = full.assoc_f[:, 6:9]
    seen = lite.ml_gated & lite.ml_inlier                  # [M]

    # ---- 4a. local-map maintenance -----------------------------------
    # new-landmark slot allocation: invalid slots first, then oldest-seen
    # (stable: equal keys, the many -inf of free slots, keep slot order)
    key = torch.where(p.lm_valid, p.lm_last.to(_F32),
                      torch.full_like(p.lm_X[:, 0], -np.inf))
    order = torch.sort(key, stable=True)[1]                # [Kl]
    rank = tri_good.to(_I32).cumsum(0) - 1
    can_alloc = tri_good & (rank < Kl)
    slot = torch.where(can_alloc, order[rank.clamp(0, Kl - 1)],
                       torch.full_like(rank, Kl))

    # matched local-map slots are distinct (one match per slot), so the
    # seen writes hit distinct rows; the slot writes follow, as in JAX
    idx_seen_a = torch.where(seen, ia_l, torch.full_like(ia_l, Kl))
    lm_desc = _set_drop(p.lm_desc, idx_seen_a,
                        _rows(feats.descriptors, lite.ml_idx_b.long()))
    lm_desc = _set_drop(lm_desc, slot, _rows(feats.descriptors, m_idx_b))
    lm_X = _set_drop(lm_X, slot, Xw)
    lm_valid = _set_drop(p.lm_valid, slot, True)
    lm_last = _set_drop(p.lm_last, slot, fctr)
    new = _set_drop(torch.zeros_like(p.lm_valid), slot, True)
    lm_gen = p.lm_gen + new.to(_I32)

    # ---- 4b. keyframe-reference swap ---------------------------------
    ib_seen = torch.where(seen, lite.ml_idx_b.long(),
                          torch.full_like(ia_l, K))
    ib_new = torch.where(can_alloc, m_idx_b, torch.full_like(m_idx_b, K))
    no = torch.zeros(K, dtype=torch.bool, device=dev)
    has_lm = _set_drop(_set_drop(no, ib_seen, True), ib_new, True)
    # landmark position per current keypoint (the loop entry's 3D snapshot)
    lmw_kp = _set_drop(torch.zeros((K, 3), dtype=_F32, device=dev),
                       ib_seen, lm_X[ia_l])
    lmw_kp = _set_drop(lmw_kp, ib_new, Xw)

    # ---- 4c. window-ring append + observation grid -------------------
    full_ring = p.win_n >= W

    def roll(a, ax):
        return torch.where(full_ring, torch.roll(a, -1, ax), a)

    win_R = roll(win_R, 0)
    win_t = roll(win_t, 0)
    win_valid = roll(p.win_valid, 0)
    win_fid = roll(p.win_fid, 0)
    obs_x = roll(p.obs_x, 1)
    obs_ok = roll(p.obs_ok, 1)
    wi = torch.where(full_ring, torch.full_like(p.win_n, W - 1), p.win_n)
    hot = torch.arange(W, device=dev) == wi                # [W]
    win_R = torch.where(hot[:, None, None], R_cur, win_R)
    win_t = torch.where(hot[:, None], t_cur, win_t)
    win_valid = win_valid | hot
    win_fid = torch.where(hot, fctr, win_fid)
    win_n = (p.win_n + 1).clamp(max=W)
    # the appended column starts empty (after a roll it holds the evicted
    # oldest camera's wrapped observations)
    obs_ok = obs_ok & ~hot[None, :]
    # newly allocated slots hold brand-new landmarks: clear their rows
    obs_ok = obs_ok & (lm_gen == p.lm_gen)[:, None]
    # tracked-landmark observations of the new keyframe
    obs_x = _set2_drop(obs_x, idx_seen_a, wi, lite.ml_x)
    obs_ok = _set2_drop(obs_ok, idx_seen_a, wi, True)
    # triangulated landmarks: observed by the previous keyframe (wi - 1)
    # and the new one (wi)
    wprev = (wi - 1).clamp(0, W - 1)
    obs_x = _set2_drop(obs_x, slot, wprev, full.assoc_f[:, 2:4])
    obs_ok = _set2_drop(obs_ok, slot, wprev, wi >= 1)
    obs_x = _set2_drop(obs_x, slot, wi, full.assoc_f[:, 4:6])
    obs_ok = _set2_drop(obs_ok, slot, wi, True)

    # ---- 5. loop database entry + retrieval --------------------------
    kp = feats.keypoints
    descF, g = _global_desc(feats)
    score = (torch.where(kp.valid, kp.response,
                         torch.full_like(kp.response, -np.inf))
             + has_lm.to(_F32) * 1e6)
    sub = top_k(score, Ks)[1]
    sub_desc = descF[sub]
    sub_yx = kp.yx[sub]
    sub_haslm = has_lm[sub] & kp.valid[sub]
    sub_lmw = lmw_kp[sub]

    # retrieval + verification (against the pre-append database)
    sims = p.db_g @ g                                      # [CAP]
    elig = torch.arange(CAP, device=dev) < (p.db_n - cfg.loop.exclude_recent)
    top_sims, cand = top_k(torch.where(elig, sims, torch.full_like(sims, -2.0)),
                           NC)
    sub_cfg = _sub_match_cfg(cfg)
    cd = [getattr(p, f).index_select(0, cand) for f in _DB_FIELDS[1:]]
    ver = torch.stack([
        _verify_candidate(sub_desc, sub_yx, sub_haslm, sub_lmw,
                          cd[0][j], cd[1][j], cd[3][j], cd[2][j],
                          cd[4][j], cd[5][j], intr, sub_cfg, cfg.loop.sim3,
                          a_R=R_cur, a_t=t_cur)
        for j in range(NC)])
    loop_pack = torch.cat([cand.to(_F32)[:, None], top_sims[:, None], ver],
                          1)                               # [NC, LOOP_REC]

    # database append, in place on this batch's own copy of the ring
    wr = torch.where(p.db_n < CAP, p.db_n, torch.full_like(p.db_n, CAP))
    for name, val in zip(_DB_FIELDS, (g, sub_desc, sub_yx, sub_lmw,
                                      sub_haslm, R_cur, t_cur)):
        _ring_write(getattr(p, name), wr, val)

    # ---- promotion record + the frame's stats row --------------------
    hdr = torch.cat([i.to(_F32).reshape(1), full.stats[:1],
                     full.stats.new_zeros(HDR - 2)])
    ai = torch.cat([full.assoc_i.to(_F32), slot.to(_F32)[:, None]], 1)
    rec = torch.cat([hdr, ai.reshape(-1), full.assoc_f.reshape(-1),
                     loop_pack.reshape(-1)])
    prom_buf = _set_drop(c.prom_buf, c.prom_n.reshape(1), rec[None])
    stats = _set_row(c.stats, i, _stats_row(step.lite, R_cur, t_cur, p.vel,
                                            1.0))

    p = p._replace(
        R=R_cur, t=t_cur,
        kf_desc=feats.descriptors, kf_yx=kp.yx, kf_valid=kp.valid,
        kf_has_lm=has_lm, kf_R=R_cur, kf_t=t_cur,
        lm_desc=lm_desc, lm_X=lm_X, lm_valid=lm_valid, lm_last=lm_last,
        lm_gen=lm_gen,
        win_R=win_R, win_t=win_t, win_valid=win_valid, win_fid=win_fid,
        win_n=win_n, obs_x=obs_x, obs_ok=obs_ok, ba_cost=ba_cost,
        db_n=(p.db_n + 1).clamp(max=CAP))
    return _Carry(p=p, prom_n=c.prom_n + 1, prom_buf=prom_buf, stats=stats)


def engine_pack(c: _Carry, R0: torch.Tensor, t0: torch.Tensor,
                vel0: torch.Tensor, start, stop) -> torch.Tensor:
    """The batch's packed buffer. Frames before `start` (an int or a 0-d
    device tensor) report the batch's input pose, frames from `stop` on its
    final one, both with zero stats, as the JAX package's masked scan
    steps do."""
    p = c.p
    B = c.stats.shape[0]
    frame = torch.arange(B, device=c.stats.device)
    z4, z2 = c.stats.new_zeros(4), c.stats.new_zeros(2)
    before = torch.cat([z4, R0.reshape(-1), t0, vel0, z2])
    after = torch.cat([z4, p.R.reshape(-1), p.t, p.vel, z2])
    stats = torch.where((frame < start)[:, None], before,
                        torch.where((frame >= stop)[:, None], after, c.stats))
    return torch.cat([
        stats.reshape(-1),
        c.prom_n.to(_F32)[None],
        p.db_n.to(_F32)[None],
        c.prom_buf.reshape(-1),
        # telemetry tail: post-BA window + landmark state for the host map
        p.win_R.reshape(-1), p.win_t.reshape(-1),
        p.win_fid.to(_F32), p.win_valid.to(_F32),
        p.lm_X.reshape(-1), p.lm_valid.to(_F32),
        p.ba_cost.reshape(1),
    ])


def promotions_cap(B: int, cfg: SlamConfig) -> int:
    """P, the promotion records a batch of B frames has room for."""
    return max(1, -(-B // max(1, cfg.keyframe_min_gap)))


def run_engine_batch(persist: EnginePersist, dyn: EngineDyn,
                     feats_b: Features, intr: torch.Tensor, cfg: SlamConfig,
                     ok_min: int, max_depth: float,
                     kernels: Kernels = KERNELS):
    """The whole-batch program, eagerly. Returns (packed f32 buffer, new
    persist).

    packed layout: [B*24 stats][prom_n][db_n][P * prom_record_size(M)]
    [tail_size(W, Kl) telemetry tail]. stats row: the track_step_lite
    stats [0:4], then R(9), t(3), vel(6) after the frame (post-promotion
    on a promoted frame), [22] promoted, [23] spare.

    engine_step on every active frame, engine_promote where its `need`
    reads True: one host sync per active frame, none per promotion.
    Float32 matmuls (TF32 off)."""
    f32_matmul()
    B = feats_b.keypoints.yx.shape[0]
    P = promotions_cap(B, cfg)
    dev = persist.R.device
    with span("engine_load"):
        # the loop database is copied once, the promotions append to the
        # copy
        persist = persist._replace(
            **{f: getattr(persist, f).clone() for f in _DB_FIELDS})
        c = engine_enter(persist, dyn.kill, dyn.kill_gen, B, P,
                         cfg.match.max_matches)
        base = torch.full((), dyn.frame_base, dtype=_I32, device=dev)
    for i in range(dyn.start, dyn.stop):
        with span("engine_step"):
            idx = torch.full((), i, dtype=_I32, device=dev)
            c, step = engine_step(c, feats_b, idx, base, intr, cfg, ok_min,
                                  P, kernels)
        # the one data-dependent branch: a host read per active frame
        with span("sync_need"):
            need = bool(step.need.item())
        if need:
            with span("engine_promote"):
                c = engine_promote(c, step, idx, base, intr, cfg, max_depth,
                                   P, ok_min, kernels)
    with span("engine_pack"):
        packed = engine_pack(c, persist.R, persist.t, persist.vel,
                             dyn.start, dyn.stop)
    return packed, c.p


def engine_relocalize(persist: EnginePersist, db_n, feats: Features,
                      intr: torch.Tensor, cfg: SlamConfig) -> torch.Tensor:
    """Database relocalization for an unlocalized frame: retrieval without
    temporal exclusion + verification of the top NC candidates. Returns
    [NC, 2 + 20] rows of [cand, sim, verify-record]."""
    f32_matmul()
    CAP = persist.db_g.shape[0]
    Ks = cfg.loop.sub_keypoints
    dev = persist.R.device
    descF, g = _global_desc(feats)
    kp = feats.keypoints
    score = torch.where(kp.valid, kp.response,
                        torch.full_like(kp.response, -np.inf))
    sub = top_k(score, Ks)[1]
    q_desc = descF[sub]
    q_yx = kp.yx[sub]

    sims = persist.db_g @ g
    simsm = torch.where(torch.arange(CAP, device=dev) < db_n, sims,
                        torch.full_like(sims, -2.0))
    top_sims, cand = top_k(simsm, NC)
    sub_cfg = _sub_match_cfg(cfg)
    cd = [getattr(persist, f).index_select(0, cand) for f in _DB_FIELDS[1:]]
    no_lm = torch.zeros(Ks, dtype=torch.bool, device=dev)
    no_X = torch.zeros((Ks, 3), dtype=_F32, device=dev)
    # entry side carries the landmarks; the query is the camera being
    # located, initialized at the entry's (corrected) pose
    ver = torch.stack([
        _verify_candidate(cd[0][j], cd[1][j], cd[3][j], cd[2][j],
                          q_desc, q_yx, no_lm, no_X, cd[4][j], cd[5][j],
                          intr, sub_cfg, False)
        for j in range(NC)])
    return torch.cat([cand.to(_F32)[:, None], top_sims[:, None], ver], 1)


def apply_correction(persist: EnginePersist, Rg, tg, sg, Rc, tc, n,
                     Rl, tl, sl) -> EnginePersist:
    """Propagate pose-graph corrections into the device state.

    Database entries k < n adopt the corrected pose (Rc[k], tc[k]) and their
    landmark snapshots move by their own world-side Sim(3):
    X' = sg (X @ Rg^T) + tg. The live state (local-map landmarks, window
    poses, pose state, keyframe reference) moves by the latest keyframe's
    world correction (Rl, tl, sl): X' = sl (X @ Rl^T) + tl, poses
    T' = descale(T . G^-1). The velocity twist is not rescaled, as in the
    reference."""
    f32_matmul()
    dev = persist.R.device

    def T(x):
        return torch.as_tensor(np.asarray(x) if not torch.is_tensor(x)
                               else x, dtype=_F32, device=dev)

    Rg, tg, sg, Rc, tc, Rl, tl, sl = map(T, (Rg, tg, sg, Rc, tc, Rl, tl, sl))
    CAP = persist.db_g.shape[0]
    mask = torch.arange(CAP, device=dev) < n
    lmw = (torch.einsum("nkd,ned->nke", persist.db_lmw, Rg)
           * sg[:, None, None] + tg[:, None, :])
    m3 = mask[:, None, None]

    Rli = Rl.T
    tli = -(Rl.T @ tl) / sl
    sli = 1.0 / sl

    def corr_pose(R, t):
        # T' = (R Rli, (R tli + t) / sli)
        return R @ Rli, (torch.einsum("...ij,j->...i", R, tli) + t) / sli

    lm_X = sl * (persist.lm_X @ Rl.T) + tl
    win_R, win_t = corr_pose(persist.win_R, persist.win_t)
    R_s, t_s = corr_pose(persist.R, persist.t)
    kf_R, kf_t = corr_pose(persist.kf_R, persist.kf_t)
    return persist._replace(
        lm_X=lm_X, win_R=win_R, win_t=win_t,
        R=R_s, t=t_s, kf_R=kf_R, kf_t=kf_t,
        db_lmw=torch.where(m3, lmw, persist.db_lmw),
        db_R=torch.where(m3, Rc, persist.db_R),
        db_t=torch.where(mask[:, None], tc, persist.db_t))


# ---------------------------------------------------------------------
# host-side codec + state builders
# ---------------------------------------------------------------------


class PromRecord(NamedTuple):
    """Host-decoded promotion record."""

    frame: int               # index within the batch
    n2d: int                 # 2D-2D match count vs the previous keyframe
    lm_slot: np.ndarray      # [M] local-map slot of tracked association
    lm_kp: np.ndarray        # [M] current keypoint index
    lm_obs: np.ndarray       # [M] bool gated & PnP-inlier (an observation)
    lm_x: np.ndarray         # [M, 2] normalized observation
    m_idx_a: np.ndarray      # [M] previous-keyframe keypoint
    m_idx_b: np.ndarray      # [M] current keypoint
    tri_good: np.ndarray     # [M] bool new landmark accepted
    tri_slot: np.ndarray     # [M] engine local-map slot assigned (Kl = none)
    m_x1: np.ndarray         # [M, 2]
    m_x2: np.ndarray         # [M, 2]
    tri_X: np.ndarray        # [M, 3]
    loop: np.ndarray         # [NC, LOOP_REC] retrieval+verify results


class EngineTail(NamedTuple):
    """Host-decoded telemetry tail: the post-BA window + landmark state
    the host mirrors into its map (lag-1)."""

    win_R: np.ndarray        # [W, 3, 3]
    win_t: np.ndarray        # [W, 3]
    win_fid: np.ndarray      # [W] int64
    win_valid: np.ndarray    # [W] bool
    lm_X: np.ndarray         # [Kl, 3]
    lm_valid: np.ndarray     # [Kl] bool
    ba_cost: float


def decode_packed(packed, B: int, M: int, P: int, W: int, Kl: int):
    """Inverse of run_engine_batch's packing (a numpy array or a CPU
    tensor). Returns (stats [B, 24], [PromRecord...], db_n, EngineTail)."""
    a = np.asarray(packed)
    o = B * 24
    stats = a[:o].reshape(B, 24)
    prom_n = int(a[o])
    db_n = int(a[o + 1])
    o += 2
    PROD = prom_record_size(M)
    recs = []
    for p in range(prom_n):
        r = a[o + p * PROD: o + (p + 1) * PROD]
        hdr = r[:HDR]
        ai = r[HDR: HDR + M * 7].reshape(M, 7).astype(np.int64)
        af = r[HDR + M * 7: HDR + M * 16].reshape(M, 9)
        loop = r[HDR + M * 16:].reshape(NC, LOOP_REC)
        recs.append(PromRecord(
            frame=int(hdr[0]), n2d=int(hdr[1]),
            lm_slot=ai[:, 0], lm_kp=ai[:, 1],
            lm_obs=(ai[:, 2] & 1).astype(bool) & (ai[:, 2] & 2).astype(bool),
            lm_x=af[:, 0:2],
            m_idx_a=ai[:, 3], m_idx_b=ai[:, 4],
            tri_good=(ai[:, 5] & 2).astype(bool), tri_slot=ai[:, 6],
            m_x1=af[:, 2:4], m_x2=af[:, 4:6], tri_X=af[:, 6:9],
            loop=loop))
    o += P * PROD
    win_R = a[o:o + W * 9].reshape(W, 3, 3).astype(np.float32)
    o += W * 9
    win_t = a[o:o + W * 3].reshape(W, 3).astype(np.float32)
    o += W * 3
    win_fid = a[o:o + W].astype(np.int64)
    o += W
    win_valid = a[o:o + W] > 0.5
    o += W
    lm_X = a[o:o + Kl * 3].reshape(Kl, 3).astype(np.float32)
    o += Kl * 3
    lm_valid = a[o:o + Kl] > 0.5
    o += Kl
    tail = EngineTail(win_R=win_R, win_t=win_t, win_fid=win_fid,
                      win_valid=win_valid, lm_X=lm_X, lm_valid=lm_valid,
                      ba_cost=float(a[o]))
    return stats, recs, db_n, tail


class LoopRow(NamedTuple):
    """Host-decoded loop verify row."""

    cand: int
    sim: float
    n_usable: int
    n_inl: int
    R: np.ndarray
    t: np.ndarray
    scale: float
    n_both: int
    recip_inl: int           # reciprocal-PnP inliers (0 on one-sided runs)
    rot_consist_deg: float   # relative-rotation agreement of the two PnPs
    trans_consist: float     # translation disagreement / median scene depth
    baseline_frac: float     # measured baseline / median scene depth


def decode_loop_row(row: np.ndarray) -> LoopRow:
    return LoopRow(
        int(row[0]), float(row[1]), int(row[2]), int(row[3]),
        row[4:13].reshape(3, 3).astype(np.float32),
        row[13:16].astype(np.float32), float(row[16]), int(row[17]),
        int(row[18]), float(row[19]), float(row[20]), float(row[21]))


def loop_row_accept(r: LoopRow, min_inliers: int, rot_deg: float,
                    trans_frac: float, baseline_frac: float) -> bool:
    """Mutual-verification acceptance for an engine loop row: the forward
    and reciprocal PnPs must independently support the edge (symmetric
    inlier rule), agree geometrically, and come from a genuine revisit
    (small baseline vs scene depth)."""
    lo = max(1, min_inliers // 2)
    return bool(
        max(r.n_inl, r.recip_inl) >= min_inliers
        and min(r.n_inl, r.recip_inl) >= lo
        and r.rot_consist_deg <= rot_deg
        and r.trans_consist <= trans_frac
        and r.baseline_frac <= baseline_frac)


def build_persist_from_host(slam_map, cfg: SlamConfig, R, t, vel,
                            since_kf: int, db_entries=None,
                            old_persist=None,
                            db_capacity: int | None = None,
                            db_count: int | None = None, device="cuda"):
    """Assemble an EnginePersist on `device` from host state (engine entry
    after bootstrap / two-view init, recovery, or checkpoint resume).

    Local map + keyframe ref + window ring + observation grid come from the
    host map (its last keyframe must hold a host descriptor copy). The loop
    database comes from `old_persist` when one exists, with the host count
    `db_count` (if given) as the ring's write index, else from host
    LoopCloser-style `db_entries`.

    Returns (persist, lmap_ids [Kl] global landmark slot per engine slot,
    db_n (None when the database came from old_persist))."""
    Kl = cfg.local_map_size
    Ks = cfg.loop.sub_keypoints
    W = cfg.ba.max_cameras
    CAP = db_capacity or cfg.loop.db_capacity

    def T(x, dtype=None):
        # a copy: the persist never shares memory with the host map
        return torch.tensor(np.asarray(x, dtype), device=device)

    kf = slam_map.last_keyframe_slot()
    desc = slam_map.kf_desc[kf]
    if desc is None:
        raise RuntimeError(
            "engine entry needs host descriptors for the last keyframe "
            "(bootstrap/init/recovery paths fetch them)")
    K = desc.shape[0]
    Df = float_desc_dim(desc.shape[1], desc.dtype)
    lmap, ids = build_local_map(slam_map, Kl, desc.shape[1], desc.dtype,
                                device=device)

    # window ring, left-aligned (oldest at index 0) + observation grid
    win_R = np.tile(np.eye(3, dtype=np.float32), (W, 1, 1))
    win_t = np.zeros((W, 3), np.float32)
    win_valid = np.zeros(W, bool)
    win_fid = np.zeros(W, np.int32)
    obs_x = np.zeros((Kl, W, 2), np.float32)
    obs_ok = np.zeros((Kl, W), bool)
    rev = {int(g): k for k, g in enumerate(ids) if g >= 0}
    slots = [s for s in slam_map.kf_order if slam_map.kf_valid[s]][-W:]
    for w, s in enumerate(slots):
        win_R[w] = slam_map.kf_R[s]
        win_t[w] = slam_map.kf_t[s]
        win_valid[w] = True
        win_fid[w] = int(slam_map.kf_frame_id[s])
        if s in slam_map.obs:
            lm_idx, lm_uid, uv = slam_map.obs[s]
            keep = (slam_map.lm_valid[lm_idx]
                    & (slam_map.lm_uid[lm_idx] == lm_uid))
            for g_lm, p_uv in zip(lm_idx[keep], uv[keep]):
                k = rev.get(int(g_lm))
                if k is not None:
                    obs_x[k, w] = p_uv
                    obs_ok[k, w] = True

    if old_persist is not None:
        db = tuple(getattr(old_persist, f) for f in _DB_FIELDS)
        db_n = None      # caller keeps its own count
        # the host count is authoritative at re-enter: device entries past
        # it (speculative promotions discarded by a recovery) are dropped
        # by resetting the ring write index
        db_n_dev = (T(db_count, np.int32) if db_count is not None
                    else old_persist.db_n)
    else:
        db_g = np.zeros((CAP, Df), np.float32)
        db_desc = np.zeros((CAP, Ks, Df), np.float32)
        db_yx = np.zeros((CAP, Ks, 2), np.float32)
        db_lmw = np.zeros((CAP, Ks, 3), np.float32)
        db_haslm = np.zeros((CAP, Ks), bool)
        db_R = np.tile(np.eye(3, dtype=np.float32), (CAP, 1, 1))
        db_t = np.zeros((CAP, 3), np.float32)
        n = 0
        for e in (db_entries or []):
            if n >= CAP:
                break
            if e.desc is None:
                # device-resident entry whose ring data is gone: keep the
                # index slot for alignment; a zero global descriptor can
                # never pass the cosine gate
                n += 1
                continue
            db_g[n] = e.global_desc
            k = min(Ks, e.desc.shape[0])
            db_desc[n, :k] = e.desc[:k]
            db_yx[n, :k] = e.yx[:k]
            db_lmw[n, :k] = e.lm_world[:k]
            db_haslm[n, :k] = e.has_lm[:k]
            db_R[n] = e.R
            db_t[n] = e.t
            n += 1
        db = tuple(T(x) for x in
                   (db_g, db_desc, db_yx, db_lmw, db_haslm, db_R, db_t))
        db_n = n
        db_n_dev = T(n, np.int32)

    kp_lm = slam_map.kf_kp_lm[kf]
    persist = EnginePersist(
        R=T(R, np.float32), t=T(t, np.float32), vel=T(vel, np.float32),
        since_kf=T(since_kf, np.int32),
        kf_desc=T(desc),
        kf_yx=T(slam_map.kf_yx[kf], np.float32),
        kf_valid=T(slam_map.kf_kp_valid[kf]),
        kf_has_lm=T(kp_lm[:K] >= 0),
        kf_R=T(slam_map.kf_R[kf]), kf_t=T(slam_map.kf_t[kf]),
        lm_desc=lmap.desc, lm_X=lmap.X, lm_valid=lmap.valid,
        lm_last=torch.zeros(Kl, dtype=_I32, device=device),
        lm_gen=torch.zeros(Kl, dtype=_I32, device=device),
        win_R=T(win_R), win_t=T(win_t), win_valid=T(win_valid),
        win_fid=T(win_fid), win_n=T(len(slots), np.int32),
        obs_x=T(obs_x), obs_ok=T(obs_ok),
        ba_cost=T(-1.0, np.float32),
        db_n=db_n_dev,
        db_g=db[0], db_desc=db[1], db_yx=db[2], db_lmw=db[3],
        db_haslm=db[4], db_R=db[5], db_t=db[6])
    return persist, ids, db_n


def db_append_host(persist: EnginePersist, n, g, desc, yx, lmw, haslm,
                   R, t) -> EnginePersist:
    """Append one host-assembled entry at ring index n (keeps the device
    ring aligned with the host loop closer when a host-path keyframe lands
    while a device database exists). n: an int or a 0-d device index; n >=
    CAP drops the entry, as the reference's mode="drop" (a write to a
    trash row: no Python-scalar assignment, no host read). The entry's
    arrays may be numpy or tensors; each is cast to its field's type."""
    dev = persist.R.device
    CAP = persist.db_g.shape[0]
    n = _on_device(persist.db_n, n)
    idx = n.clamp(max=CAP).reshape(1)
    out = {}
    for f, v in zip(_DB_FIELDS, (g, desc, yx, lmw, haslm, R, t)):
        x = getattr(persist, f)
        v = torch.as_tensor(v if torch.is_tensor(v) else np.asarray(v),
                            device=dev).to(x.dtype)
        out[f] = _set_drop(x, idx, v)
    return persist._replace(db_n=torch.maximum(persist.db_n, n + 1), **out)


def _upload(dev: torch.device, arrays) -> list:
    """Host arrays as float32 tensors on dev in ONE copy (through pinned
    memory on the card: no host sync), each in its own shape."""
    flat = [np.asarray(a, np.float32) for a in arrays]
    buf = torch.from_numpy(np.concatenate([a.reshape(-1) for a in flat]))
    if dev.type == "cuda":
        buf = buf.pin_memory()
    buf = buf.to(dev, non_blocking=True)
    out, o = [], 0
    for a in flat:
        out.append(buf[o:o + a.size].view(a.shape))
        o += a.size
    return out


def _correct_body(x: tuple, cfg: tuple) -> EnginePersist:
    return apply_correction(*x)


def _append_body(x: tuple, cfg: tuple) -> EnginePersist:
    return db_append_host(*x)


class DatabaseProgram:
    """`engine_programs(...)["db_correct"]` (apply_correction) and
    `["db_append"]` (db_append_host): `fn`, called as fn is, with the
    persist, an entry count or index n and host arrays, as a seedless
    utils.graphs.GraphProgram: one captured graph per shape key on the
    card, the function itself on the CPU. The host arrays are uploaded
    outside the graph in one copy (`_upload`) and n becomes a 0-d device
    index by a fill, so the body reads nothing from host memory; the
    result is the caller's (copies of the graph's outputs)."""

    def __init__(self, fn, body, n_at: int, cfg: SlamConfig):
        self.fn, self.n_at, self.cfg = fn, n_at, cfg
        self.program = GraphProgram(body, seeded=False)

    def __call__(self, persist: EnginePersist, *args) -> EnginePersist:
        args = list(args)
        n = args.pop(self.n_at)
        x = _upload(persist.R.device, args)
        x.insert(self.n_at, _on_device(persist.db_n, int(n)))
        return self.program((persist, *x), (self.cfg, KERNELS))


# ---------------------------------------------------------------------
# engine_programs: the entry points replayed from captured CUDA graphs
# ---------------------------------------------------------------------


class _BatchGraphs:
    """run_engine_batch for one shape key as four graphs over one static
    carry: enter (kill list, empty records), step (engine_step of the next
    frame), promote (engine_promote of that frame), pack. The call copies
    the caller's persist, features, intrinsics and kill list in, so any
    input of this key replays. graphs=False runs the same bodies over the
    same static buffers without capturing them."""

    def __init__(self, prog: "EngineProgram", persist: EnginePersist,
                 dyn: EngineDyn, feats_b: Features, intr: torch.Tensor,
                 kernels: Kernels, graphs: bool = True):
        cfg, ok_min, max_depth = prog.cfg, prog.ok_min, prog.max_depth
        B = feats_b.keypoints.yx.shape[0]
        P = promotions_cap(B, cfg)
        dev = persist.R.device
        cap = _Capture(dev) if graphs else None
        self.persist = _map(_static, persist)
        self.feats = _map(_static, feats_b)
        self.intr = _static(intr)
        self.kill, self.kill_gen = _static(dyn.kill), _static(dyn.kill_gen)
        self.base, self.i, self.start, self.stop = (
            torch.zeros((), dtype=_I32, device=dev) for _ in range(4))
        self.R0, self.t0, self.vel0 = map(_static, (persist.R, persist.t,
                                                    persist.vel))
        self.carry = _Carry(
            p=self.persist, prom_n=torch.zeros((), dtype=_I32, device=dev),
            prom_buf=torch.zeros((P, prom_record_size(cfg.match.max_matches)),
                                 dtype=_F32, device=dev),
            stats=torch.zeros((B, 24), dtype=_F32, device=dev))

        def enter():
            c = engine_enter(self.persist, self.kill, self.kill_gen, B, P,
                             cfg.match.max_matches)
            _assign(self.carry, c)
            _assign((self.R0, self.t0, self.vel0),
                    (self.persist.R, self.persist.t, self.persist.vel))

        def step():
            self.i.add_(1)
            c, out = engine_step(self.carry, self.feats, self.i, self.base,
                                 self.intr, cfg, ok_min, P, kernels)
            _assign(self.carry, c)
            return out

        def promote(out: StepOut):
            c = engine_promote(self.carry, out, self.i, self.base,
                               self.intr, cfg, max_depth, P, ok_min, kernels)
            _assign(self.carry, c)

        def pack():
            return engine_pack(self.carry, self.R0, self.t0, self.vel0,
                               self.start, self.stop)

        f32_matmul()
        self.capture_s, self.pool_bytes = 0.0, 0
        if not graphs:
            self.g_enter, self.g_step, self.g_pack = map(
                _Uncaptured, (enter, step, pack))
            self.g_promote = _Uncaptured(lambda: promote(self.g_step.out))
            return
        self._load(persist, dyn, feats_b, intr)
        cap.warm_up(lambda: (enter(), promote(step()), pack()))
        self.g_enter = cap.graph(enter)
        self.g_step = cap.graph(step)
        self.g_promote = cap.graph(lambda: promote(self.g_step.out))
        self.g_pack = cap.graph(pack)
        self.scratch = cap.scratch      # the graphs read it: keep it alive
        # the statics, the scratch and the four graphs' private pools
        self.capture_s, self.pool_bytes = cap.done()

    def _load(self, persist, dyn, feats_b, intr) -> None:
        _copy_all(_leaves((self.persist, self.feats, self.intr, self.kill,
                           self.kill_gen)),
                  _leaves((persist, feats_b, intr, dyn.kill, dyn.kill_gen)))
        self.base.fill_(dyn.frame_base)
        self.i.fill_(dyn.start - 1)
        self.start.fill_(dyn.start)
        self.stop.fill_(dyn.stop)

    def run(self, persist, dyn, feats_b, intr):
        with span("engine_load"):
            self._load(persist, dyn, feats_b, intr)
            self.g_enter.replay()
        for _ in range(dyn.start, dyn.stop):
            with span("engine_step"):
                out = self.g_step.replay()
            # the one host read per active frame
            with span("sync_need"):
                need = bool(out.need.item())
            if need:
                with span("engine_promote"):
                    self.g_promote.replay()
        with span("engine_pack"):
            packed = self.g_pack.replay()
            return packed.clone(), _clone_all(self.persist)


class EngineProgram:
    """`engine_programs(...)["batch"]`: run_engine_batch, called as
    program(persist, dyn, feats_b, intr, kernels).

    On a CUDA device the batch replays CUDA graphs captured once per shape
    key (the shapes, dtypes and device of every input, as the JAX package's
    jit retraces on B, K, Kl, M, W and CAP) and per kernel set: the
    counterpart of its one compiled program. The first call of a key warms
    the bodies up on a side stream and captures them; a body that cannot
    be captured raises (the call never runs the eager loop instead). A call
    copies its inputs into the key's static buffers, replays the step graph
    per active frame, reads that frame's `need` (one host sync), replays
    the promote graph where it is set, packs, and returns copies: the
    packed buffer and a persist that no later replay overwrites; the
    caller's persist is left as it was. Replays run on the current stream,
    one call at a time per program.

    On the CPU the program is run_engine_batch itself (the caller asked
    for the CPU), and so it is for the plain path (a kernel set whose
    triangulation is the plain `triangulate_ref`, ops.cuda.PLAIN): its
    `torch.linalg.eigh` reads cuSOLVER's status to the host, which no
    graph can hold, so the plain path, the card's eager reference, stays
    eager by construction. Either is decided from the arguments before
    anything runs, never after a failure."""

    def __init__(self, cfg: SlamConfig, ok_min: int, max_depth: float):
        self.cfg, self.ok_min, self.max_depth = cfg, ok_min, max_depth
        self.captured: dict = {}

    def __call__(self, persist: EnginePersist, dyn: EngineDyn,
                 feats_b: Features, intr: torch.Tensor,
                 kernels: Kernels = KERNELS):
        if (persist.R.device.type != "cuda"
                or kernels.triangulate_dlt is triangulate.triangulate_ref):
            return run_engine_batch(persist, dyn, feats_b, intr, self.cfg,
                                    self.ok_min, self.max_depth, kernels)
        key = (_signature(persist, feats_b, intr, dyn.kill, dyn.kill_gen),
               kernels)
        graphs = self.captured.get(key)
        if graphs is None:
            graphs = _BatchGraphs(self, persist, dyn, feats_b, intr, kernels)
            self.captured[key] = graphs
        return graphs.run(persist, dyn, feats_b, intr)


class _RelocalizeGraph:
    """engine_relocalize for one shape key as one graph over static copies
    of the loop database, its count, the frame and the intrinsics."""

    def __init__(self, cfg: SlamConfig, persist: EnginePersist,
                 feats: Features, intr: torch.Tensor):
        dev = persist.R.device
        cap = _Capture(dev)
        db = {f: _static(getattr(persist, f)) for f in _DB_FIELDS}
        # the other fields are not read: empty placeholders on the device
        self.persist = EnginePersist(**{
            f: db.get(f, torch.empty(0, device=dev))
            for f in EnginePersist._fields})
        self.db_n = torch.zeros((), dtype=_I32, device=dev)
        self.feats = _map(_static, feats)
        self.intr = _static(intr)
        self._load(persist, 0, feats, intr)

        def body():
            return engine_relocalize(self.persist, self.db_n, self.feats,
                                     self.intr, cfg)

        cap.warm_up(body)
        self.graph = cap.graph(body)
        self.scratch = cap.scratch      # the graph reads it: keep it alive
        self.capture_s, self.pool_bytes = cap.done()

    def _load(self, persist, db_n, feats, intr) -> None:
        _copy_all(_leaves(([getattr(self.persist, f) for f in _DB_FIELDS],
                           self.feats, self.intr)),
                  _leaves(([getattr(persist, f) for f in _DB_FIELDS], feats,
                           intr)))
        if torch.is_tensor(db_n):
            self.db_n.copy_(db_n)
        else:
            self.db_n.fill_(int(db_n))

    def run(self, persist, db_n, feats, intr) -> torch.Tensor:
        self._load(persist, db_n, feats, intr)
        return self.graph.replay().clone()


class RelocalizeProgram:
    """`engine_programs(...)["relocalize"]`: engine_relocalize, called as
    program(persist, db_n, feats, intr), replayed on a CUDA device from
    one graph per shape key (`prepare` captures it ahead of use, as the
    JAX package compiles it in Tracker.prewarm_aux); on the CPU the
    function itself."""

    def __init__(self, cfg: SlamConfig):
        self.cfg = cfg
        self.captured: dict = {}

    def _graph(self, persist, feats, intr) -> _RelocalizeGraph:
        key = _signature([getattr(persist, f) for f in _DB_FIELDS], feats,
                         intr)
        graph = self.captured.get(key)
        if graph is None:
            graph = _RelocalizeGraph(self.cfg, persist, feats, intr)
            self.captured[key] = graph
        return graph

    def prepare(self, persist: EnginePersist, feats: Features,
                intr: torch.Tensor) -> None:
        """Capture the graph of these shapes without running it."""
        if persist.R.device.type == "cuda":
            self._graph(persist, feats, intr)

    def __call__(self, persist: EnginePersist, db_n, feats: Features,
                 intr: torch.Tensor) -> torch.Tensor:
        if persist.R.device.type != "cuda":
            return engine_relocalize(persist, db_n, feats, intr, self.cfg)
        return self._graph(persist, feats, intr).run(persist, db_n, feats,
                                                     intr)


def empty_frame(persist: EnginePersist) -> Features:
    """A frame of invalid, zeroed features with the shapes and types of the
    persist's keyframe (for capturing a program ahead of its first
    frame)."""
    K = persist.kf_valid.shape[0]
    dev = persist.R.device
    return Features(Keypoints.empty(K, dev), torch.zeros_like(persist.kf_desc))


@functools.lru_cache(maxsize=32)
def engine_programs(cfg: SlamConfig, ok_min: int, max_depth: float) -> dict:
    """The engine's entry points, shared across Tracker instances (the JAX
    package's cache of jitted programs, with its four keys):

      "batch"       EngineProgram: run_engine_batch from captured graphs
      "relocalize"  RelocalizeProgram: engine_relocalize from one graph
      "db_correct"  DatabaseProgram: apply_correction from one graph
      "db_append"   DatabaseProgram: db_append_host from one graph

    The last two run once per loop closure or host-path keyframe and take
    host arrays, which they upload outside their graphs."""
    return {
        "batch": EngineProgram(cfg, ok_min, max_depth),
        "relocalize": RelocalizeProgram(cfg),
        "db_correct": DatabaseProgram(apply_correction, _correct_body, 5,
                                      cfg),
        "db_append": DatabaseProgram(db_append_host, _append_body, 0, cfg),
    }

"""Monocular SLAM tracking loop (visualslam_tpu/slam/tracker.py).

Host-side orchestration of the port's device functions:

  frontend  SIFT / ORB / Harris features       frontend.make_frontend
  matching  ratio + mutual matcher              models/matching
  init      essential RANSAC + triangulation    geometry/ransac
  tracking  motion-only LM (PnP refine)         slam/track_step
  mapping   DLT triangulation of new landmarks  slam/track_step
  backend   sliding-window Schur BA             backend/ba
  engine    whole batches on the device         slam/engine
  loops     retrieval, verification, graphs     slam/loop_closure

Pose convention: world-to-camera (x_cam = R X_w + t); world frame = first
keyframe. Monocular scale is fixed at two-view init by normalizing the
median scene depth to `init_depth`.

The engine runs through `engine.engine_programs` (shared per config, as
the JAX package's jitted programs): on the card every engine batch,
database relocalization, loop correction and host-path database append
replays CUDA graphs captured once per shape; on the CPU the same entry
points are the eager functions. The JAX package's other jitted programs
(`_shared_programs`: "frontend" / "frontend_batched", "match", "ransac",
"track_lite", "track_batch", "kf_step", "stack_stats") are programs here
too, shared per config: on the card every detection call replays one
captured graph of the batched frontend (the upload stays outside it), the
two-view init's match and its RANSAC, pose recovery and triangulation
replay one graph each, the init reading its results back as one packed
buffer (one host sync per call), and the host path (engine=False, and
`process`'s single frame) tracks a batch, a frame and a promotion by one
replay each, the frame index a device tensor, with the stats and the
packed keyframe products read back outside the graphs. The tracker hands
out the eager frontend module (`Tracker.frontend`, the one `cfg.frontend`
names) to callers that ask for it, and owns one `torch.Generator` as the
RANSAC key chain, from which each two-view init draws the seed of its
draws, as the reference splits its PRNG key.
Everything runs on `device` (the card unless the caller asks
for the CPU); `kernels` picks the kernel
path (ops.cuda.KERNELS) or the plain path (ops.cuda.PLAIN). The lag-1
`process_stream` keeps the reference's contract; the engine's packed
telemetry comes back through a pinned host buffer and a CUDA event (the
reference's `copy_to_host_async`).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from visualslam_tpu_torch.backend.ba import (
    BAProblem,
    run_ba_packed_jit,
    unpack_ba_result,
)
from visualslam_tpu_torch.frontend import frontend_body, frontend_module
from visualslam_tpu_torch.geometry import ransac
from visualslam_tpu_torch.geometry.camera import normalized
from visualslam_tpu_torch.models.matching import match_body
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.slam import engine
from visualslam_tpu_torch.slam.engine import engine_programs
from visualslam_tpu_torch.slam.map_state import SlamMap
from visualslam_tpu_torch.slam.track_step import (
    KeyframeRef,
    TrackAssoc,
    TrackLite,
    TrackState,
    build_local_map,
    index_features,
    keyframe_step,
    lite_at,
    pack_keyframe_products,
    track_batch,
    track_step_lite,
    unpack_keyframe_products,
)
from visualslam_tpu_torch.utils.card import require_device
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.profiling import sink, span


def _entry(method):
    """A public entry of the Tracker: `self.timer` is the active
    profiling sink while it runs, so every layer under it reports its
    spans there (utils/profiling.span)."""

    @functools.wraps(method)
    def entry(self, *args, **kwargs):
        with sink(self.timer):
            return method(self, *args, **kwargs)

    return entry


def _tree_map(fn, tree):
    """fn over every tensor leaf of nested NamedTuples."""
    if isinstance(tree, tuple):
        return type(tree)(*(_tree_map(fn, x) for x in tree))
    return fn(tree)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _track_lite_body(x, cfg):
    """The JAX tracker's "track_lite": track_step_lite of frame i of fb.
    x = (lmap, fb, i, state, intr), i a 0-d device index; cfg =
    ((SlamConfig, ok_min), Kernels)."""
    lmap, fb, i, state, intr = x
    (scfg, ok_min), kernels = cfg
    return track_step_lite(lmap, index_features(fb, i), state, intr, scfg,
                           ok_min, kernels)


def _track_batch_body(x, cfg):
    """The JAX tracker's "track_batch": track_batch of x = (lmap, fb,
    start, state, intr), start a 0-d device index, so one graph serves
    every restart index; cfg as "track_lite"'s."""
    lmap, fb, start, state, intr = x
    (scfg, ok_min), kernels = cfg
    return track_batch(lmap, fb, start, state, intr, scfg, ok_min, kernels)


def _kf_step_body(x, cfg):
    """The JAX tracker's "kf_step": keyframe_step of frame i of x = (kf,
    fb, i, bl, intr), i a 0-d device index; cfg = ((SlamConfig,
    max_depth), Kernels). Returns (the packed products, the frame's
    Features): the host reads both back."""
    kf, fb, i, bl, intr = x
    (scfg, max_depth), kernels = cfg
    feats = index_features(fb, i)
    full = keyframe_step(kf, feats, lite_at(bl, i), intr, scfg, max_depth,
                         kernels)
    return pack_keyframe_products(full, feats), feats


def _stack_stats(x, cfg):
    """The JAX tracker's "stack_stats": x, a tuple of stats rows, stacked
    (defined there and never called; kept so that the keys match)."""
    return torch.stack(x)


def _ransac_body(x, cfg, gen):
    """The JAX tracker's "ransac" program: estimate_relative_pose of x =
    (x1, x2, valid) under cfg = (RansacConfig, Kernels), drawing from gen.
    The function is looked up in geometry/ransac at every call, so a test
    that replaces it (or its sampler) reaches the CPU path."""
    x1, x2, valid = x
    rcfg, kernels = cfg
    return ransac.estimate_relative_pose(x1, x2, valid, rcfg, gen, kernels)


@functools.lru_cache(maxsize=32)
def _shared_programs(cfg: SlamConfig) -> dict:
    """The tracker's programs, shared by every Tracker with an equal config
    (the JAX package's `_shared_programs`), so a warm-up tracker's capture
    serves the trackers after it:

      "frontend", "frontend_batched"
                 one seedless utils.graphs.GraphProgram of the batched
                 frontend (frontend.frontend_body), called as
                 program((imgs,), (cfg, kernels)) with imgs [B, H, W] on
                 the device: the JAX package's single-frame program is its
                 B = 1 key;
      "match"    match_features, called as program((fa, fb), (cfg.match,
                 kernels));
      "ransac"   estimate_relative_pose, called as program((x1, x2, valid),
                 (cfg.ransac, kernels), seed);
      "track_lite"   track_step_lite of one frame of a batch, called as
                 program((lmap, fb, i, state, intr), ((cfg, ok_min),
                 kernels)), i a 0-d device index (`_track`: a batch of
                 one, as the JAX package tracks a single frame);
      "track_batch"  track_batch, program((lmap, fb, start, state, intr),
                 ((cfg, ok_min), kernels)), start a 0-d device index;
      "kf_step"  keyframe_step of frame i + the packed products,
                 program((kf, fb, i, bl, intr), ((cfg, max_depth),
                 kernels)) -> (packed, the frame's Features);
      "stack_stats"  torch.stack of a tuple of stats rows (unused, as in
                 the JAX package).

    All but "ransac" are seedless. Each is a utils.graphs.GraphProgram:
    one captured graph per shape key on the card (the plain kernel set,
    which reads the host, runs eagerly) and the function on the CPU.
    "track_lite" (B = 1) and "track_batch" are separate programs, so
    neither evicts the other's keys."""
    frontend = GraphProgram(frontend_body, seeded=False)
    return {"frontend": frontend, "frontend_batched": frontend,
            "match": GraphProgram(match_body, seeded=False),
            "ransac": GraphProgram(_ransac_body),
            "track_lite": GraphProgram(_track_lite_body, seeded=False),
            "track_batch": GraphProgram(_track_batch_body, seeded=False),
            "kf_step": GraphProgram(_kf_step_body, seeded=False),
            "stack_stats": GraphProgram(_stack_stats, seeded=False)}


class TwoViewHost(NamedTuple):
    """A two-view init's results on the host, read back as one buffer
    (`_pack_two_view`): the pose and, per match slot, the point, the final
    inlier flag, the matched keypoints and their normalized coordinates."""
    n: int                    # final inliers
    n_match: int              # valid matches
    R: np.ndarray             # [3, 3]
    t: np.ndarray             # [3]
    X: np.ndarray             # [M, 3] camera-1 frame
    inl: np.ndarray           # [M] bool
    idx_a: np.ndarray         # [M] int64
    idx_b: np.ndarray         # [M] int64
    x1: np.ndarray            # [M, 2]
    x2: np.ndarray            # [M, 2]


def _pack_two_view(m, x1, x2, R, t, X, inl, n) -> torch.Tensor:
    """One float32 buffer [14 + 10 M] of a two-view init's results (the
    counts and indices are exact in float32 below 2^24)."""
    f = torch.float32
    head = torch.cat([n.reshape(1).to(f), m.count().reshape(1).to(f),
                      R.reshape(9).to(f), t.reshape(3).to(f)])
    rows = torch.cat([X.to(f), inl[:, None].to(f), m.idx_a[:, None].to(f),
                      m.idx_b[:, None].to(f), x1.to(f), x2.to(f)], 1)
    return torch.cat([head, rows.reshape(-1)])


def _unpack_two_view(buf: np.ndarray) -> TwoViewHost:
    rows = buf[14:].reshape(-1, 10)
    return TwoViewHost(
        n=int(buf[0]), n_match=int(buf[1]), R=buf[2:11].reshape(3, 3),
        t=buf[11:14].copy(), X=rows[:, 0:3], inl=rows[:, 3] > 0.5,
        idx_a=rows[:, 4].astype(np.int64), idx_b=rows[:, 5].astype(np.int64),
        x1=rows[:, 6:8], x2=rows[:, 8:10])


def _transform_telemetry(G, stats, recs, tail):
    """Move one batch's decoded engine telemetry from the pre-correction
    world frame into the corrected frame: points X' = s (X @ Rg^T) + tg,
    world-to-camera poses T' = descale(T . G^-1), the Sim(3) the loop
    correction applied to the host map and the device state."""
    Rg, tg, sg = G
    Rgi = Rg.T
    tgi = -(Rg.T @ tg) / sg
    sgi = 1.0 / sg

    def pose(R, t):
        return R @ Rgi, (R @ tgi + t) / sgi

    def points(X):
        return sg * (X @ Rg.T) + tg

    stats = stats.copy()
    for j in range(stats.shape[0]):
        R, t = pose(stats[j, 4:13].reshape(3, 3), stats[j, 13:16])
        stats[j, 4:13] = R.reshape(-1)
        stats[j, 13:16] = t
    out_recs = []
    for r in recs:
        # loop rows carry the candidate camera's ABSOLUTE pose in the (old)
        # verification frame: it moves frames too
        loop = r.loop.copy()
        for c in range(loop.shape[0]):
            Rv, tv = pose(loop[c, 4:13].reshape(3, 3), loop[c, 13:16])
            loop[c, 4:13] = Rv.reshape(-1)
            loop[c, 13:16] = tv
        out_recs.append(r._replace(tri_X=points(r.tri_X), loop=loop))
    win_R = tail.win_R.copy()
    win_t = tail.win_t.copy()
    for w in range(win_R.shape[0]):
        win_R[w], win_t[w] = pose(win_R[w], win_t[w])
    tail = tail._replace(win_R=win_R, win_t=win_t, lm_X=points(tail.lm_X))
    return stats, out_recs, tail


@dataclass
class FrameResult:
    frame_id: int
    R: np.ndarray               # world-to-camera
    t: np.ndarray
    num_matches: int = 0
    num_inliers: int = 0
    is_keyframe: bool = False
    tracking_ok: bool = True


class Tracker:
    """Monocular tracker with sliding-window BA."""

    def __init__(self, cfg: SlamConfig, intrinsics, init_depth: float = 20.0,
                 run_ba: bool = True, loop_closure: bool | None = None,
                 mesh=None, engine: bool = True, device="cuda",
                 kernels: Kernels = KERNELS):
        """engine: process_batch runs the device-resident engine
        (slam/engine.py: keyframe promotion, local-map maintenance and loop
        retrieval / verification inside one batch call). False keeps the
        host-orchestrated keyframe path.

        device: where every tensor lives, the card unless the caller passes
        device="cpu"; without a card the default raises. kernels:
        ops.cuda.KERNELS (default) or ops.cuda.PLAIN.

        mesh: optional parallel/mesh.Mesh with a 'shard' axis: the host
        path's window BA (and global_ba unless overridden) runs
        trajectory-sharded over its devices (parallel/traj_ba.py)."""
        if mesh is not None and "shard" not in mesh.shape:
            raise ValueError("Tracker: the mesh needs a 'shard' axis")
        self.mesh = mesh
        self.device = require_device(device, "Tracker")
        if cfg.frontend == "orb" and cfg.match.metric != "hamming":
            # ORB descriptors are bit-packed uint32: match on Hamming
            cfg = cfg.replace(match=cfg.match.replace(metric="hamming"))
        self.cfg = cfg
        self.kernels = kernels
        self.intr = torch.as_tensor(np.asarray(_host(intrinsics), np.float32),
                                    device=self.device)
        self.init_depth = init_depth
        self.run_ba = run_ba
        # landmark pool decoupled from the BA padded shapes
        self.map_landmarks = max(cfg.map_landmarks, cfg.ba.max_landmarks)
        if loop_closure is None:
            loop_closure = cfg.loop.enabled
        self.loop_closer = None
        if loop_closure:
            from visualslam_tpu_torch.slam.loop_closure import LoopCloser

            self.loop_closer = LoopCloser(
                self.intr, cfg.match, cfg.pose_graph,
                sub_keypoints=cfg.loop.sub_keypoints,
                cosine_threshold=cfg.loop.cosine_threshold,
                min_inliers=cfg.loop.min_inliers,
                exclude_recent=cfg.loop.exclude_recent,
                use_sim3=cfg.loop.sim3, max_scale=cfg.loop.max_scale,
                device=self.device, kernels=kernels)
        self.num_loop_closures = 0
        self._loop_cooldown_until = -1   # db index gating closure acceptance
        self.map = SlamMap(cfg.ba.max_cameras, self.map_landmarks,
                           self._feat_capacity())
        self.frames: list[FrameResult] = []
        self._prev_feats: Optional[Features] = None
        self._frames_since_kf = 0
        self._last_R = np.eye(3, dtype=np.float32)
        self._last_t = np.zeros(3, np.float32)
        self._vel = np.zeros(6, np.float32)  # constant-velocity model (twist)
        self._lost_streak = 0
        self.relocalizations = 0       # recoveries (re-init or db reloc)
        self.db_relocalizations = 0    # recoveries that PnP'd into the db
        self.max_lost_frames = 5  # consecutive failures before re-init

        # RANSAC randomness: a host generator as the key chain, split into
        # a fresh device generator per two-view init (the reference splits
        # its PRNG key there)
        self._gen = torch.Generator().manual_seed(cfg.ransac.seed)
        self._frame = None   # (frame shape, dtype) of the last detection
        self._track_ok_min = max(10, cfg.keyframe_min_inliers // 3)
        self._max_depth = float(init_depth) * 20.0
        self._eng_progs = engine_programs(self.cfg, self._track_ok_min,
                                          self._max_depth)
        self._progs = _shared_programs(self.cfg)
        # device-side caches, rebuilt at every keyframe / correction
        self._kf_ref: Optional[KeyframeRef] = None
        self._lmap = None
        self._lmap_ids = np.full(cfg.local_map_size, -1, np.int64)
        self._state: Optional[TrackState] = None
        # device-resident engine state (slam/engine.py)
        self.engine = engine
        self._eng_persist = None     # EnginePersist
        self._eng_ids = None         # [Kl] map landmark slot per engine slot
        self._eng_uids = None        # [Kl] landmark uid at association time
        self._eng_gen = None         # [Kl] mirror of the device lm_gen
        self._eng_db_n = 0           # loop-database entries in the ring
        self._eng_ready = False      # device state in sync with host map
        # lag-1 stream state (process_stream): the in-flight batch whose
        # packed telemetry has not been harvested yet
        self._inflight = None   # (readback, feats_b, first_fid, i0, B, stop)
        self._stream_B = None   # stream batch size (tail padding)
        # world-frame Sim(3) for the NEXT harvest's decoded telemetry: a
        # batch dispatched before a loop correction ran in the
        # pre-correction frame
        self._pending_world_G = None    # (Rg, tg, sg) or None
        # optional utils.profiling.StageTimer (or any object with a
        # stage(name) context manager): the sink of every span reported
        # while a public entry runs
        self.timer = None

    def _feat_capacity(self) -> int:
        return (self.cfg.sift.max_keypoints if self.cfg.frontend == "sift"
                else self.cfg.orb.max_keypoints)

    # ------------------------------------------------------------------
    # the device functions the reference jits (_shared_programs)
    # ------------------------------------------------------------------

    @property
    def frontend(self):
        """The eager frontend module of the tracker's config on `device`
        (frontend.frontend_module: the one cfg.frontend names, whose
        constants the "frontend_batched" program reads), for callers that
        ask for it; detect_batch replays the program."""
        return frontend_module(self.cfg, self.kernels, self.device)

    def _match(self, fa: Features, fb: Features):
        """The "match" program on two frames' Features."""
        return self._progs["match"]((fa, fb), (self.cfg.match, self.kernels))

    def _index(self, i: int) -> torch.Tensor:
        """A frame index as a 0-d int32 tensor on the device (a fill: no
        copy from the host), the tracking programs' index argument."""
        return self.intr.new_full((), i, dtype=torch.int32)

    def _split_seed(self) -> int:
        """The next seed of the RANSAC key chain (a host generator)."""
        return int(torch.randint(0, 2 ** 62, (1,), generator=self._gen))

    def _ransac(self, x1: torch.Tensor, x2: torch.Tensor,
                valid: torch.Tensor):
        """The "ransac" program on the init's correspondences, drawing from
        the next seed of the key chain: (R, t, X, inliers, n)."""
        return self._progs["ransac"]((x1, x2, valid),
                                     (self.cfg.ransac, self.kernels),
                                     self._split_seed())

    def _kf_step(self, kf: KeyframeRef, fb: Features, i: int, bl):
        """The "kf_step" program on frame i of the batch: (packed products,
        the frame's Features)."""
        return self._progs["kf_step"](
            (kf, fb, self._index(i), bl, self.intr),
            ((self.cfg, self._max_depth), self.kernels))

    def _readback(self, x: torch.Tensor):
        """Start the device-to-host copy of x: a pinned buffer, a
        non-blocking copy and an event on the card; x itself on the CPU."""
        if x.device.type != "cuda":
            return x, None
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x, non_blocking=True)
        ev = torch.cuda.Event()
        ev.record()
        return host, ev

    @staticmethod
    def _fetch(readback) -> np.ndarray:
        host, ev = readback
        if ev is not None:
            with span("sync_readback"):
                ev.synchronize()
        return host.numpy()

    # ------------------------------------------------------------------

    @_entry
    def process(self, img, frame_id: int) -> FrameResult:
        feats = self.features_at(self.detect_batch(np.asarray(img)[None]), 0)
        return self.process_features(feats, frame_id)

    def upload_batch(self, imgs) -> torch.Tensor:
        """Host -> device upload of a frame batch (uint8 stays uint8, other
        types become float32), through pinned memory on the card."""
        if torch.is_tensor(imgs):
            return imgs.to(self.device)
        imgs = np.asarray(imgs)
        if imgs.dtype != np.uint8:
            imgs = imgs.astype(np.float32, copy=False)
        t = torch.from_numpy(np.ascontiguousarray(imgs))
        if self.device.type == "cuda":
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def detect_batch(self, imgs) -> Features:
        """Batched detection: [B, H, W] -> Features with a leading batch
        axis, in one call of the "frontend_batched" program (a replay of
        its captured graph on the card). uint8 input is uploaded as-is and
        normalized to [0, 1] on the device."""
        x = self.upload_batch(imgs)
        self._frame = (tuple(x.shape[1:]), x.dtype)
        return self._progs["frontend_batched"]((x,), (self.cfg, self.kernels))

    @staticmethod
    def features_at(batched: Features, i: int) -> Features:
        """Frame i's Features from a batched Features."""
        return index_features(batched, i)

    @_entry
    def process_batch(self, imgs, first_frame_id: int):
        """Detect a batch in one call, then track the WHOLE batch: the
        engine batch program, or (engine=False) track_batch with one
        stats read-back, re-entering after each keyframe promotion so that
        the frames after it see the new keyframe's landmarks."""
        B = imgs.shape[0]
        with span("frontend_dispatch"):
            feats_b = self.detect_batch(imgs)
        results: list[FrameResult] = []
        i = 0
        while i < B:
            fid = first_frame_id + i
            if not self.map.kf_order or not self.map.lm_valid.any():
                # bootstrap / two-view init are host-driven paths
                results.append(self.process_features(
                    self.features_at(feats_b, i), fid))
                i += 1
                continue
            if self.engine:
                out, i = self._engine_run(feats_b, first_frame_id, i, B)
                results.extend(out)
                continue
            if self._kf_ref is None:
                self._refresh_device_cache()
            with span("track_dispatch"):
                # frames [i, B) active
                st, bl = self._progs["track_batch"](
                    (self._lmap, feats_b, self._index(i), self._state,
                     self.intr), ((self.cfg, self._track_ok_min),
                                  self.kernels))
            with span("stats_readback"):
                # ONE [B, 22] read-back
                stats = self._fetch(self._readback(bl.stats))
            self._state = st
            disp = "ok"
            j = i
            while j < B:
                res, disp = self._commit_tracked_frame(
                    first_frame_id + j, feats_b, bl, j, stats[j])
                results.append(res)
                j += 1
                if disp in ("kf", "restart"):
                    break
            i = j
            if disp == "kf":
                with span("refresh_cache"):
                    self._refresh_device_cache()
            # "restart": recovery reset the map/caches itself
        return results

    # ------------------------------------------------------------------
    # lag-1 pipelined streaming (the throughput path)
    # ------------------------------------------------------------------

    @_entry
    def process_stream(self, imgs, first_frame_id: int):
        """Dispatch THIS batch's frontend + engine batch, then harvest the
        PREVIOUS batch's telemetry. Call `finish()` after the last batch.
        Returns the FrameResults committed by this call (usually the
        previous batch's). Synchronous while the engine isn't active
        (bootstrap, two-view init, recovery)."""
        out: list[FrameResult] = []
        if (not self.engine or not self.map.kf_order
                or not self.map.lm_valid.any()):
            if not self.engine:
                # the host path's stream batch (prewarm_aux's keys)
                self._stream_B = max(self._stream_B or 0, imgs.shape[0])
            out.extend(self.finish())
            out.extend(self.process_batch(imgs, first_frame_id))
            return out
        n = imgs.shape[0]
        # pad short tail batches up to the stream batch size (the
        # reference's engine program is compiled per B)
        B = max(self._stream_B or 0, n)
        self._stream_B = B
        if n < B:
            if torch.is_tensor(imgs):
                imgs = torch.cat([imgs, imgs[-1:].expand(B - n,
                                                         *imgs.shape[1:])])
            else:
                imgs = np.asarray(imgs)
                imgs = np.concatenate(
                    [imgs, np.repeat(imgs[-1:], B - n, axis=0)])
        with span("frontend_dispatch"):
            feats_b = self.detect_batch(imgs)
        # this batch's engine call goes before the previous batch's
        # telemetry is consumed: nothing in EngineDyn depends on it (kill
        # lists land one batch late)
        prev = self._inflight
        self._inflight = self._engine_dispatch(feats_b, first_frame_id,
                                               0, B, stop=n)
        if prev is not None:
            out.extend(self._harvest_inflight(prev))
        return out

    @_entry
    def finish(self) -> list:
        """Harvest any in-flight batch (after the last process_stream, and
        before reading trajectories/maps)."""
        inflight, self._inflight = self._inflight, None
        if inflight is None:
            return []
        return self._harvest_inflight(inflight)

    @_entry
    def prewarm_aux(self) -> None:
        """Capture the rare-event programs outside any timed loop, where
        the reference compiles them: the loop closer's pose-graph program
        (Sim(3) or SE(3) per cfg.loop.sim3, at the padded shapes its next
        closure uses, on the tracker's device; LoopCloser.prepare) and,
        once it holds a host entry, its verify programs at the database's
        shapes (LoopCloser.warm_verify); once the tracker has streamed a
        batch the frontend program's key at the stream's batch shape; on
        the host path (engine=False), once tracking has started, the keys
        of "match", "track_lite" and "kf_step" at one frame and of
        "track_batch" and "kf_step" at the stream's batch; and, once the
        engine has run (it reads the persist's shapes), the database
        relocalization's graph (engine_programs' "relocalize"). Unlike the
        reference's warm-up, it runs no closure: the tracker's state is
        left as it was, so any tracker may call it. The database
        correction and append capture on their first call. On the CPU
        there is nothing to capture."""
        lc = self.loop_closer
        if lc is not None:
            lc.prepare()
            host = [e for e in lc.entries if e.desc is not None]
            if host:
                lc.warm_verify(host[-1].desc.shape[1])
        if self._stream_B is not None and self._frame is not None:
            shape, dtype = self._frame
            self._progs["frontend_batched"].prepare(
                (torch.zeros((self._stream_B,) + shape, dtype=dtype,
                             device=self.device),), (self.cfg, self.kernels))
        if not self.engine:
            self._prewarm_host_path()
        if self._eng_persist is None:
            return
        self._eng_progs["relocalize"].prepare(
            self._eng_persist, engine.empty_frame(self._eng_persist),
            self.intr)

    def _prewarm_host_path(self) -> None:
        """prewarm_aux's host-path keys, from the device caches' shapes
        (zero frames; nothing runs)."""
        one = self._prev_feats
        if one is None or self._lmap is None or self._kf_ref is None:
            return
        progs, kern = self._progs, self.kernels
        progs["match"].prepare((one, one), (self.cfg.match, kern))
        for B in sorted({1, self._stream_B or 1}):
            fb = _tree_map(lambda x: x.new_zeros((B,) + x.shape), one)
            x = (self._lmap, fb, self._index(0), self._state, self.intr)
            progs["track_lite" if B == 1 else "track_batch"].prepare(
                x, ((self.cfg, self._track_ok_min), kern))
            progs["kf_step"].prepare(
                (self._kf_ref, fb, self._index(0), self._lite_template(B),
                 self.intr), ((self.cfg, self._max_depth), kern))

    def _lite_template(self, B: int) -> TrackLite:
        """A zero TrackLite of B frames (the shapes track_batch returns)."""
        M = self.cfg.match.max_matches

        def z(*shape, dtype=torch.float32):
            return torch.zeros((B,) + shape, dtype=dtype, device=self.device)

        i32, b = torch.int32, torch.bool
        return TrackLite(R=z(3, 3), t=z(3), vel=z(6), stats=z(22),
                         ml_idx_a=z(M, dtype=i32), ml_idx_b=z(M, dtype=i32),
                         ml_gated=z(M, dtype=b), ml_inlier=z(M, dtype=b),
                         ml_x=z(M, 2), ok=z(dtype=b))

    def _harvest_inflight(self, inflight) -> list:
        """Harvest a dispatched batch. If the harvest aborts mid-batch
        (sustained loss -> recovery), a batch dispatched AFTER it
        speculated from a lost state: drop its results and re-track both
        tails synchronously (detection is reused)."""
        _, feats_b, first_fid, _, _, stop = inflight
        results, nxt = self._engine_harvest(inflight)
        if nxt < stop:
            spec, self._inflight = self._inflight, None
            results.extend(self.process_batch_features(feats_b, first_fid,
                                                       nxt, stop))
            if spec is not None:
                _, feats_s, fid_s, _, _, stop_s = spec
                results.extend(
                    self.process_batch_features(feats_s, fid_s, 0, stop_s))
        return results

    def process_batch_features(self, feats_b, first_fid: int, i0: int,
                               stop: int) -> list:
        """Synchronously track frames [i0, stop) of an already-detected
        batch (bootstrap / init / recovery per frame, the engine once the
        map is live). The batch may be padded past `stop`."""
        B = int(feats_b.keypoints.valid.shape[0])
        results: list[FrameResult] = []
        i = i0
        while i < stop:
            if (self.engine and self.map.kf_order
                    and self.map.lm_valid.any()):
                out, i = self._engine_run(feats_b, first_fid, i, B, stop)
                results.extend(out)
                continue
            results.append(self.process_features(
                self.features_at(feats_b, i), first_fid + i))
            i += 1
        return results

    # ------------------------------------------------------------------
    # device-resident engine (slam/engine.py)
    # ------------------------------------------------------------------

    def _engine_enter(self) -> None:
        """(Re)build the engine's device state from the host map. A
        surviving device loop database is carried forward."""
        entries = self.loop_closer.entries if self.loop_closer else None
        persist, ids, db_n = engine.build_persist_from_host(
            self.map, self.cfg, self._last_R, self._last_t, self._vel,
            self._frames_since_kf, db_entries=entries,
            old_persist=self._eng_persist, db_count=self._eng_db_n,
            device=self.device)
        self._eng_persist = persist
        self._eng_ids = ids.astype(np.int64)
        g = np.maximum(ids, 0)
        self._eng_uids = np.where(ids >= 0, self.map.lm_uid[g], -1)
        self._eng_gen = np.zeros(len(ids), np.int64)
        if db_n is not None:
            self._eng_db_n = db_n
        self._eng_ready = True

    def _engine_dyn(self, start_i: int, first_fid: int, stop_i: int):
        """Per-batch host input: frame counters + the (usually empty) kill
        list of engine slots whose host landmark was recycled or
        invalidated since the last batch."""
        ids = self._eng_ids
        g = np.maximum(ids, 0)
        stale = (ids >= 0) & ~(self.map.lm_valid[g]
                               & (self.map.lm_uid[g] == self._eng_uids))
        kill_gen = np.where(stale, self._eng_gen, -1).astype(np.int32)
        ids[stale] = -1
        self._eng_uids[stale] = -1
        # two pageable uploads: the host waits for each copy
        with span("sync_kill_upload"):
            kill = torch.from_numpy(stale).to(self.device)
        with span("sync_kill_upload"):
            kill_gen = torch.from_numpy(kill_gen).to(self.device)
        return engine.EngineDyn(
            frame_base=int(first_fid), start=int(start_i), stop=int(stop_i),
            kill=kill, kill_gen=kill_gen)

    def _engine_dispatch(self, feats_b, first_fid: int, i0: int, B: int,
                         stop: int | None = None):
        """Run the whole-batch engine call and start the read-back of its
        packed telemetry. Frames [i0, stop) are active. Returns the
        in-flight record for _engine_harvest."""
        if stop is None:
            stop = B
        if not self._eng_ready:
            self._engine_enter()
        with span("engine_dyn"):
            dyn = self._engine_dyn(i0, first_fid, stop)
        with span("engine_dispatch"):
            packed_dev, persist = self._engine_batch(self._eng_persist, dyn,
                                                     feats_b)
        self._eng_persist = persist
        return (self._readback(packed_dev), feats_b, first_fid, i0, B, stop)

    def _engine_batch(self, persist, dyn, feats_b):
        """One engine batch: engine_programs' "batch" (captured graphs on
        the card). Returns (packed, new persist); neither aliases the
        program's buffers, so the packed read-back queued after it reads
        this batch."""
        return self._eng_progs["batch"](persist, dyn, feats_b, self.intr,
                                        self.kernels)

    def _engine_harvest(self, inflight):
        """Consume one batch's telemetry: decode stats + promotion records,
        mirror the post-BA window poses and landmark positions into the
        host map, drive loop-closure pose graphs, and handle tracking-loss
        recovery. Returns (FrameResults, next index): next < stop only
        when a sustained loss forced a mid-batch recovery."""
        readback, feats_b, first_fid, i0, B, stop = inflight
        with span("engine_readback"):
            packed = self._fetch(readback)
        M = self.cfg.match.max_matches
        P = max(1, -(-B // max(1, self.cfg.keyframe_min_gap)))
        W = self.cfg.ba.max_cameras
        Kl = self.cfg.local_map_size
        with span("decode"):
            stats, recs, db_n_dev, tail = engine.decode_packed(
                packed, B, M, P, W, Kl)
        pending, self._pending_world_G = self._pending_world_G, None
        if pending is not None:
            stats, recs, tail = _transform_telemetry(pending, stats, recs,
                                                     tail)
        rec_by_frame = {r.frame: r for r in recs}

        results: list[FrameResult] = []
        loop_hits = []
        n_applied = 0
        for j in range(i0, stop):
            fid = first_fid + j
            srow = stats[j]
            n_match = int(srow[0])
            n_inl = int(srow[1])
            R = srow[4:13].reshape(3, 3).astype(np.float32)
            t = srow[13:16].astype(np.float32)
            promoted = srow[22] > 0.5
            ok = n_inl >= self._track_ok_min
            self._frames_since_kf += 1
            self._vel = srow[16:22].astype(np.float32)
            if not ok:
                self._lost_streak += 1
                if self._lost_streak > self.max_lost_frames:
                    # commit what was applied, then host-driven recovery;
                    # device db entries past the applied count are dropped
                    self._eng_db_n += n_applied
                    from_db = self._recover(self.features_at(feats_b, j),
                                            fid)
                    results.append(self._store_result(
                        fid, self._last_R, self._last_t,
                        num_matches=n_match, num_inliers=0,
                        is_keyframe=True, tracking_ok=from_db))
                    return results, j + 1
            else:
                self._lost_streak = 0
            if promoted:
                rec = rec_by_frame[j]
                with span("kf_apply"):
                    hit = self._engine_apply_prom(rec, fid, R, t)
                n_applied += 1
                self._frames_since_kf = 0
                if hit is not None:
                    loop_hits.append(hit)
                results.append(self._store_result(
                    fid, R, t, num_matches=rec.n2d, num_inliers=n_inl,
                    is_keyframe=True, tracking_ok=True))
            else:
                results.append(self._store_result(
                    fid, R, t, num_matches=n_match, num_inliers=n_inl,
                    is_keyframe=False, tracking_ok=ok))
        self._eng_db_n = db_n_dev
        with span("tail_apply"):
            self._engine_apply_tail(tail)
        if loop_hits:
            with span("loop_optimize"):
                self._engine_apply_loops()
        return results, stop

    def _engine_run(self, feats_b, first_fid: int, i0: int, B: int,
                    stop: int | None = None):
        """Synchronous dispatch + harvest (the non-pipelined path)."""
        return self._engine_harvest(
            self._engine_dispatch(feats_b, first_fid, i0, B, stop))

    def _engine_apply_tail(self, tail) -> None:
        """Mirror the engine's post-BA state into the host map: window
        keyframe poses (by frame id) and landmark positions (through the
        slot mirror + uid check). The host map is a lag-1 replica: global
        BA, the loop-closure pose graph and recovery read it; tracking
        itself never does."""
        fid_to_slot = {int(self.map.kf_frame_id[s]): s
                       for s in self.map.kf_order}
        for w in range(len(tail.win_valid)):
            if not tail.win_valid[w]:
                continue
            s = fid_to_slot.get(int(tail.win_fid[w]))
            if s is not None:
                self.map.kf_R[s] = tail.win_R[w]
                self.map.kf_t[s] = tail.win_t[w]
        ids = self._eng_ids
        g = np.maximum(ids, 0)
        ok = ((ids >= 0) & tail.lm_valid[:len(ids)]
              & self.map.lm_valid[g]
              & (self.map.lm_uid[g] == self._eng_uids))
        self.map.X[g[ok]] = tail.lm_X[:len(ids)][ok]
        if tail.ba_cost >= 0:
            self.last_ba_cost = tail.ba_cost

    def _engine_apply_prom(self, rec, fid: int, R, t):
        """Fold one device promotion record into the host map: keyframe
        slot, tracked-landmark observations, new landmarks (triangulated +
        slot-assigned on the device), the loop-database mirror entry, and
        any verified loop edge. Returns (slot, db_idx) when an edge was
        accepted, else None."""
        prev_kf = self.map.last_keyframe_slot()
        slot, _ = self.map.allocate_keyframe()
        self.map.set_keyframe(slot, fid, R, t, None, None, None)

        ids = self._eng_ids
        Kl = len(ids)
        gid = ids[np.clip(rec.lm_slot, 0, Kl - 1)]
        sel = rec.lm_obs & (rec.lm_slot < Kl) & (gid >= 0)
        g = np.maximum(gid, 0)
        sel &= (self.map.lm_valid[g]
                & (self.map.lm_uid[g]
                   == self._eng_uids[np.clip(rec.lm_slot, 0, Kl - 1)]))
        if sel.any():
            self.map.add_observations(slot, gid[sel], rec.lm_x[sel])
            self.map.kf_kp_lm[slot][rec.lm_kp[sel]] = gid[sel]

        good = rec.tri_good & (rec.tri_slot >= 0) & (rec.tri_slot < Kl)
        if good.any():
            lm_idx = self.map.allocate_landmarks(rec.tri_X[good])
            self.map.add_observations(prev_kf, lm_idx, rec.m_x1[good])
            self.map.add_observations(slot, lm_idx, rec.m_x2[good])
            self.map.kf_kp_lm[prev_kf][rec.m_idx_a[good]] = lm_idx
            self.map.kf_kp_lm[slot][rec.m_idx_b[good]] = lm_idx
            ts = rec.tri_slot[good]
            ids[ts] = lm_idx
            self._eng_uids[ts] = self.map.lm_uid[lm_idx]
            # replay the device's allocation-generation increments so the
            # mirror stays aligned with persist.lm_gen (kill lists and
            # write-backs are gated on generation equality)
            self._eng_gen[ts] += 1

        if self.loop_closer is None:
            return None
        lc = self.loop_closer
        db_idx = lc.add_keyframe_light(fid, R, t)
        if db_idx < self._loop_cooldown_until:
            return None          # closure cooldown
        for row in rec.loop:
            r = engine.decode_loop_row(row)
            # n_usable only needs to clear the symmetric-rule floor; the
            # mutual inlier gates are the real quality bar
            if (0 <= r.cand < db_idx and r.sim >= lc.cos_thresh
                    and r.n_usable >= max(1, lc.min_inliers // 2)
                    and engine.loop_row_accept(
                        r, lc.min_inliers,
                        self.cfg.loop.consistency_rot_deg,
                        self.cfg.loop.consistency_trans,
                        self.cfg.loop.max_baseline_frac)):
                lc.add_device_edge(r.cand, db_idx, r.R, r.t, r.n_inl,
                                   r.scale, rot_sigma_deg=r.rot_consist_deg)
                self.num_loop_closures += 1
                self._loop_cooldown_until = (
                    db_idx + self.cfg.loop.cooldown_keyframes)
                return (slot, db_idx)
        return None

    def _engine_apply_loops(self) -> None:
        """Pose-graph optimization for loop edges accepted this batch, then
        correction of the host window (poses + landmarks), of the device
        database (entry poses + landmark snapshots) and of the device live
        state (local map, window ring, pose state), with no re-enter."""
        lc = self.loop_closer
        lc.optimize()
        db_idx = len(lc.entries) - 1
        self._apply_loop_correction(self.map.last_keyframe_slot(), db_idx)
        CAP = self._eng_persist.db_g.shape[0]
        n = min(len(lc.entries), CAP)
        Rg = np.tile(np.eye(3, dtype=np.float32), (CAP, 1, 1))
        tg = np.zeros((CAP, 3), np.float32)
        sg = np.ones(CAP, np.float32)
        Rc = np.tile(np.eye(3, dtype=np.float32), (CAP, 1, 1))
        tc = np.zeros((CAP, 3), np.float32)
        for k in range(n):
            Rg[k], tg[k], sg[k] = lc.last_corrections[k]
            Rc[k], tc[k] = lc.corrected[k]
        # the live state moves by the LATEST keyframe's world correction
        if lc.last_corrections is not None and db_idx < len(
                lc.last_corrections):
            Rl, tl, sl = lc.last_corrections[db_idx]
        else:
            Rl, tl, sl = (np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32), 1.0)
        self._eng_persist = self._eng_progs["db_correct"](
            self._eng_persist, Rg, tg, sg, Rc, tc, n,
            np.asarray(Rl, np.float32), np.asarray(tl, np.float32),
            np.float32(sl))
        if self._inflight is not None:
            # a speculative batch already ran in the pre-correction frame:
            # its decoded telemetry moves into the corrected frame
            self._pending_world_G = (np.asarray(Rl, np.float32),
                                     np.asarray(tl, np.float32), float(sl))

    def _engine_append_host_entry(self, entry) -> None:
        """Mirror a host-path loop-database entry (e.g. the two-view-init
        keyframes after a recovery) into the device ring so ring indices
        stay aligned with LoopCloser.entries."""
        if self._eng_persist is None or entry.desc is None:
            self._eng_db_n += 1
            return
        p = self._eng_persist
        Ks, Df = p.db_desc.shape[1], p.db_desc.shape[2]
        k = min(Ks, entry.desc.shape[0])

        def fit(a, shape, dtype=np.float32):
            out = np.zeros(shape, dtype)
            out[:k] = a[:k]
            return out

        self._eng_persist = self._eng_progs["db_append"](
            p, self._eng_db_n, entry.global_desc.astype(np.float32),
            fit(entry.desc, (Ks, Df)), fit(entry.yx, (Ks, 2)),
            fit(entry.lm_world, (Ks, 3)), fit(entry.has_lm, (Ks,), bool),
            entry.R, entry.t)
        self._eng_db_n += 1

    @_entry
    def process_features(self, feats: Features, frame_id: int) -> FrameResult:
        """Track precomputed Features (tests and other frontends bypass
        detection)."""
        if not self.map.kf_order:
            return self._bootstrap(feats, frame_id)
        if not self.map.lm_valid.any():
            return self._two_view_init(feats, frame_id)
        return self._track(feats, frame_id)

    # ------------------------------------------------------------------

    def _store_result(self, frame_id, R, t, **kw) -> FrameResult:
        # copies: R/t may be views into the keyframe ring buffer
        res = FrameResult(frame_id=frame_id,
                          R=np.array(R, np.float32, copy=True),
                          t=np.array(t, np.float32, copy=True), **kw)
        self.frames.append(res)
        self._last_R = res.R
        self._last_t = res.t
        return res

    def _new_keyframe(self, feats: Features, frame_id, R, t,
                      feats_np: Optional[Features] = None):
        """feats_np: a host copy of feats, if the caller already has one."""
        if feats_np is None:
            feats_np = _tree_map(_host, feats)
        slot, _ = self.map.allocate_keyframe()
        self.map.set_keyframe(
            slot, frame_id, np.asarray(R), np.asarray(t),
            feats_np.descriptors, np.asarray(feats_np.keypoints.yx),
            np.asarray(feats_np.keypoints.valid))
        self._prev_feats = feats
        self._frames_since_kf = 0
        return slot

    def _bootstrap(self, feats, frame_id) -> FrameResult:
        R = np.eye(3, dtype=np.float32)
        t = np.zeros(3, np.float32)
        self._new_keyframe(feats, frame_id, R, t)
        return self._store_result(frame_id, R, t, is_keyframe=True)

    # ------------------------------------------------------------------

    def _two_view_solve(self, prev: Features, feats: Features) -> TwoViewHost:
        """The "match" program, then the "ransac" program, then their
        results read back to the host as one packed buffer: the init's one
        host sync."""
        m = self._match(prev, feats)
        x1 = normalized(prev.keypoints.yx[m.idx_a.long()].flip(-1), self.intr)
        x2 = normalized(feats.keypoints.yx[m.idx_b.long()].flip(-1),
                        self.intr)
        R, t, X, inl, n = self._ransac(x1, x2, m.valid)
        return _unpack_two_view(
            _host(_pack_two_view(m, x1, x2, R, t, X, inl, n)))

    def _two_view_init(self, feats, frame_id) -> FrameResult:
        kf = self.map.last_keyframe_slot()
        prev = self._prev_feats
        tv = self._two_view_solve(prev, feats)
        n, n_match = tv.n, tv.n_match
        if n < self.cfg.keyframe_min_inliers:
            # not enough parallax/matches yet; keep waiting, but re-anchor
            # the bootstrap on the current frame after a sustained failure
            self._lost_streak += 1
            if self._lost_streak > self.max_lost_frames:
                self._recover(feats, frame_id)
            return self._store_result(frame_id, self._last_R, self._last_t,
                                      num_matches=n_match, num_inliers=n,
                                      tracking_ok=False)
        self._lost_streak = 0
        # fix monocular scale: median depth of inliers -> init_depth
        inl_np = tv.inl
        depth = np.median(tv.X[inl_np, 2])
        s = self.init_depth / max(depth, 1e-6)
        X = tv.X * s                    # points in the FIRST keyframe's frame
        t_rel = tv.t * s
        R_rel = tv.R
        # compose with the first keyframe's world pose: T2 = T_rel . T_kf1,
        # X_w = T_kf1^-1 X
        R1 = self.map.kf_R[kf]
        t1 = self.map.kf_t[kf]
        R = R_rel @ R1
        t = R_rel @ t1 + t_rel
        X = (X - t1) @ R1

        # register landmarks + observations in both keyframes
        idx_a = tv.idx_a[inl_np]
        idx_b = tv.idx_b[inl_np]
        lm_idx = self.map.allocate_landmarks(X[inl_np])
        self.map.add_observations(kf, lm_idx, tv.x1[inl_np])
        self.map.kf_kp_lm[kf][idx_a] = lm_idx

        slot = self._new_keyframe(feats, frame_id, R, t)
        self.map.add_observations(slot, lm_idx, tv.x2[inl_np])
        self.map.kf_kp_lm[slot][idx_b] = lm_idx
        self._run_window_ba()
        if self.loop_closer is not None:
            self.loop_closer.add_keyframe(
                self.map.kf_frame_id[kf], self.map.kf_R[kf],
                self.map.kf_t[kf], prev, self.map.kf_kp_lm[kf], self.map.X)
            self.loop_closer.add_keyframe(
                frame_id, self.map.kf_R[slot], self.map.kf_t[slot], feats,
                self.map.kf_kp_lm[slot], self.map.X)
            if self.engine and self._eng_persist is not None:
                # keep the device ring aligned with the host entry list
                # (post-recovery re-init path)
                self._engine_append_host_entry(self.loop_closer.entries[-2])
                self._engine_append_host_entry(self.loop_closer.entries[-1])
        self._eng_ready = False
        res = self._store_result(frame_id, self.map.kf_R[slot],
                                 self.map.kf_t[slot], num_matches=n_match,
                                 num_inliers=n, is_keyframe=True)
        self._refresh_device_cache()
        return res

    # ------------------------------------------------------------------

    def _refresh_device_cache(self) -> None:
        """Rebuild the device-side tracking caches (last-keyframe reference,
        covisible local map, pose state) from the host map."""
        kf = self.map.last_keyframe_slot()
        if self.map.kf_desc[kf] is None and self._eng_persist is not None:
            # engine-made keyframe: its descriptors live on the device
            p = self._eng_persist
            self.map.kf_desc[kf] = _host(p.kf_desc)
            self.map.kf_yx[kf] = _host(p.kf_yx)
            self.map.kf_kp_valid[kf] = _host(p.kf_valid)
        desc = self.map.kf_desc[kf]
        kp_lm = self.map.kf_kp_lm[kf]

        def T(x, dtype=None):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

        self._kf_ref = KeyframeRef(
            desc=T(desc), yx=T(self.map.kf_yx[kf], np.float32),
            kp_valid=T(self.map.kf_kp_valid[kf]), kp_has_lm=T(kp_lm >= 0),
            R=T(self.map.kf_R[kf]), t=T(self.map.kf_t[kf]))
        self._lmap, self._lmap_ids = build_local_map(
            self.map, self.cfg.local_map_size, desc.shape[1], desc.dtype,
            device=self.device)
        self._state = TrackState(R=T(self._last_R), t=T(self._last_t),
                                 vel=T(self._vel))

    def _track(self, feats, frame_id) -> FrameResult:
        if self._kf_ref is None:
            self._refresh_device_cache()
        # a batch of one: the programs index batched values
        fb = _tree_map(lambda x: x[None], feats)
        out = self._progs["track_lite"](
            (self._lmap, fb, self._index(0), self._state, self.intr),
            ((self.cfg, self._track_ok_min), self.kernels))
        self._state = TrackState(R=out.R, t=out.t, vel=out.vel)
        # the one read-back a frame
        stats = self._fetch(self._readback(out.stats))
        bl = _tree_map(lambda x: x[None], out)
        res, disp = self._commit_tracked_frame(frame_id, fb, bl, 0, stats)
        if disp == "kf":
            self._refresh_device_cache()
        return res

    def _commit_tracked_frame(self, frame_id, fb, bl, idx, stats):
        """Host-side decisions for one tracked frame given its stats. bl:
        the batch's TrackLite (leading [B] axis), kept on the device.
        Returns (FrameResult, disposition): "ok", "kf" (promoted; device
        caches NOT yet refreshed) or "restart" (recovery reset the map)."""
        n_match = int(stats[0])
        n_inl = int(stats[1])
        R = stats[4:13].reshape(3, 3).astype(np.float32)
        t = stats[13:16].astype(np.float32)

        ok = n_inl >= self._track_ok_min
        self._frames_since_kf += 1
        need_kf = (self._frames_since_kf >= self.cfg.keyframe_min_gap
                   and (n_inl < self.cfg.keyframe_min_inliers
                        or self._frames_since_kf >= self.cfg.keyframe_max_gap))
        self._vel = stats[16:22].astype(np.float32)

        if not ok:
            # failure recovery: after a sustained loss drop the map and
            # re-bootstrap from the current frame
            self._lost_streak += 1
            if self._lost_streak > self.max_lost_frames:
                from_db = self._recover(self.features_at(fb, idx), frame_id)
                return self._store_result(
                    frame_id, self._last_R, self._last_t,
                    num_matches=n_match, num_inliers=0, is_keyframe=True,
                    tracking_ok=from_db), "restart"
        else:
            self._lost_streak = 0

        if need_kf and ok:
            self._insert_keyframe_from_track(fb, bl, idx, frame_id, R, t)
            # the FrameResult and the velocity chain keep the odometry (PnP)
            # pose; the BA-adjusted pose lives in the map
            return self._store_result(frame_id, R, t, num_matches=n_match,
                                      num_inliers=n_inl, is_keyframe=True,
                                      tracking_ok=True), "kf"
        return self._store_result(frame_id, R, t, num_matches=n_match,
                                  num_inliers=n_inl, is_keyframe=False,
                                  tracking_ok=ok), "ok"

    # ------------------------------------------------------------------

    def _recover(self, feats, frame_id) -> bool:
        """Sustained-loss recovery: relocalize against the keyframe
        database (the device database in engine mode, else
        LoopCloser.relocalize) so the new map segment re-anchors at a
        map-consistent pose; else re-bootstrap at the dead-reckoned last
        pose. Returns True when the pose came from the database."""
        from_db = False
        if (self.engine and self._eng_persist is not None
                and self._eng_db_n > 0 and self.loop_closer is not None):
            rows = _host(self._eng_progs["relocalize"](
                self._eng_persist, self._eng_db_n, feats, self.intr))
            lc = self.loop_closer
            for row in rows:
                r = engine.decode_loop_row(row)
                if (r.cand >= 0 and r.sim >= lc.cos_thresh
                        and r.n_usable >= lc.min_inliers
                        and r.n_inl >= lc.min_inliers):
                    self._last_R = np.array(r.R, np.float32, copy=True)
                    self._last_t = np.array(r.t, np.float32, copy=True)
                    self.db_relocalizations += 1
                    from_db = True
                    break
        elif self.loop_closer is not None:
            r = self.loop_closer.relocalize(feats)
            if r is not None:
                R, t, _, _ = r
                self._last_R = np.array(R, np.float32, copy=True)
                self._last_t = np.array(t, np.float32, copy=True)
                self.db_relocalizations += 1
                from_db = True
        self._reinitialize(feats, frame_id)
        self._lost_streak = 0
        self.relocalizations += 1
        return from_db

    def _reinitialize(self, feats, frame_id) -> None:
        """Drop the map and re-bootstrap from the current frame at the last
        known pose (keeps the trajectory frame; mapping restarts)."""
        self.map = SlamMap(self.cfg.ba.max_cameras, self.map_landmarks,
                           self._feat_capacity())
        self._vel = np.zeros(6, np.float32)
        self._new_keyframe(feats, frame_id, self._last_R, self._last_t)
        self._kf_ref = None     # stale until the next two-view init succeeds
        self._eng_ready = False

    def _insert_keyframe_from_track(self, fb, bl, idx, frame_id, R, t):
        """Promote frame idx to a keyframe from the batch's track outputs
        (bl, on the device): tracked-landmark observations from the
        local-map association, new landmarks from the triangulated + gated
        2D-2D matches; one packed read-back + the descriptors."""
        with span("kf_step_dispatch"):
            packed, feats = self._kf_step(self._kf_ref, fb, idx, bl)
        with span("kf_readback"):
            # copies: the map keeps these arrays, not the pinned buffers
            rb = self._readback(packed), self._readback(feats.descriptors)
            packed_np, desc_np = (self._fetch(r).copy() for r in rb)
        M = self.cfg.match.max_matches
        K = desc_np.shape[0]
        _, ai, af, kp_yx, kp_resp, kp_valid = unpack_keyframe_products(
            packed_np, M, K)
        d = TrackAssoc.unpack(ai, af)
        prev_kf = self.map.last_keyframe_slot()
        # numpy Features view for the host consumers (map storage + loop
        # database); unfetched fields stay zero
        zeros_k = np.zeros(K, np.float32)
        feats_np = Features(
            Keypoints(yx=kp_yx, yx_oct=np.zeros((K, 2), np.float32),
                      octave=np.zeros(K, np.int32),
                      level=np.zeros(K, np.int32), sigma=zeros_k,
                      orientation=zeros_k, response=kp_resp, valid=kp_valid),
            desc_np)

        slot = self._new_keyframe(feats, frame_id, R, t, feats_np=feats_np)

        # 1. observations of tracked (local-map) landmarks
        lm_ids = self._lmap_ids[np.maximum(d.lm_slot, 0)]
        tracked = d.lm_valid & d.lm_inlier & (lm_ids >= 0)
        if tracked.any():
            self.map.add_observations(slot, lm_ids[tracked], d.lm_x[tracked])
            self.map.kf_kp_lm[slot][d.lm_kp[tracked]] = lm_ids[tracked]

        # 2. new landmarks: triangulation + gates already ran on the device
        good = np.asarray(d.tri_good)
        if good.any():
            lm_idx = self.map.allocate_landmarks(d.tri_X[good])
            self.map.add_observations(prev_kf, lm_idx, d.m_x1[good])
            self.map.add_observations(slot, lm_idx, d.m_x2[good])
            self.map.kf_kp_lm[prev_kf][d.m_idx_a[good]] = lm_idx
            self.map.kf_kp_lm[slot][d.m_idx_b[good]] = lm_idx

        # 3. windowed BA
        if self.run_ba:
            with span("window_ba"):
                self._run_window_ba()
        # refresh the cached current pose from the (possibly) adjusted
        # keyframe
        self._last_R = self.map.kf_R[slot].copy()
        self._last_t = self.map.kf_t[slot].copy()

        # 4. loop closure (with the already-fetched host copy of feats)
        if self.loop_closer is not None:
            with span("loop_closure"):
                idx = self.loop_closer.add_keyframe(
                    frame_id, self.map.kf_R[slot], self.map.kf_t[slot],
                    feats_np, self.map.kf_kp_lm[slot], self.map.X)
                if self.engine and self._eng_persist is not None:
                    self._engine_append_host_entry(
                        self.loop_closer.entries[-1])
                edge = (None if idx < self._loop_cooldown_until
                        else self.loop_closer.detect(idx))
                if edge is not None:
                    self.num_loop_closures += 1
                    self._loop_cooldown_until = (
                        idx + self.cfg.loop.cooldown_keyframes)
                    self.loop_closer.optimize()
                    self._apply_loop_correction(slot, idx)

        # the device caches are NOT refreshed here: the caller decides when
        # the new keyframe becomes visible to tracking
        self._eng_ready = False     # engine device state now stale

    def _apply_loop_correction(self, slot: int, db_idx: int) -> None:
        """Move the active window (poses + landmarks) so that the latest
        keyframe matches its pose-graph-corrected pose, by the world-side
        Sim(3) G = S_corr^-1 . S_old of the latest keyframe: landmarks
        X' = G X, window poses T' = descale(S_T . G^-1)."""
        lc = self.loop_closer
        if lc.last_corrections is None or db_idx >= len(lc.last_corrections):
            return
        Rg, tg, sg = lc.last_corrections[db_idx]
        Rg = np.asarray(Rg, np.float32)
        tg = np.asarray(tg, np.float32)
        sg = np.float32(sg)
        Rgi = Rg.T
        sgi = float(np.float32(1.0) / sg)
        tgi = -sgi * (Rgi @ tg)
        live = self.map.lm_valid
        self.map.X[live] = sg * (self.map.X[live] @ Rg.T) + tg
        for s in self.map.kf_order:
            R_k = self.map.kf_R[s]
            t_k = self.map.kf_t[s]
            self.map.kf_R[s] = R_k @ Rgi
            self.map.kf_t[s] = (R_k @ tgi + t_k) / sgi
        self._last_R = self.map.kf_R[slot].copy()
        self._last_t = self.map.kf_t[slot].copy()

    # ------------------------------------------------------------------

    def metrics(self) -> list:
        """Per-frame metrics as JSON-ready dicts."""
        out = []
        for f in self.frames:
            out.append({
                "frame": int(f.frame_id),
                "matches": int(f.num_matches),
                "inliers": int(f.num_inliers),
                "keyframe": bool(f.is_keyframe),
                "tracking_ok": bool(f.tracking_ok),
            })
        if out:
            out[-1]["landmarks"] = int(self.map.lm_valid.sum())
            out[-1]["keyframes"] = len(self.map.kf_order)
            out[-1]["loop_closures"] = self.num_loop_closures
            out[-1]["relocalizations"] = self.relocalizations
            out[-1]["db_relocalizations"] = self.db_relocalizations
            out[-1]["last_ba_cost"] = self.last_ba_cost
        return out

    last_ba_cost: float = -1.0
    _pending_ba = None      # (slots, fids, lm_slots, lm_uids, nC, nL, res, ev)

    def _run_window_ba(self, iters_scale: int = 1) -> None:
        # lazy flush: a previous async BA that hasn't finished rides on and
        # lands at the NEXT keyframe
        self._flush_pending_ba(wait=False)
        if self._pending_ba is not None:
            return      # previous window still optimizing; skip this one
        cfg = self.cfg.ba
        if iters_scale > 1:
            cfg = cfg.replace(iters=cfg.iters * iters_scale)
        (slots, R, t, lm_slots, X, cam_idx, lm_idx, uv,
         valid) = self.map.build_ba_arrays(cfg.max_observations)
        if len(lm_slots) < 8 or valid.sum() < 24:
            return
        C = cfg.max_cameras
        L = cfg.max_landmarks
        nC = len(slots)
        nL = len(lm_slots)
        if nL > L:
            return  # window exceeds capacity; skip

        def T(x, dtype=None):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

        p = BAProblem(
            R=T(np.concatenate([R, np.tile(np.eye(3, dtype=np.float32),
                                           (C - nC, 1, 1))])),
            t=T(np.concatenate([t, np.zeros((C - nC, 3), np.float32)])),
            X=T(np.concatenate([X, np.zeros((L - nL, 3), np.float32)])),
            cam_idx=T(cam_idx, np.int32), lm_idx=T(lm_idx, np.int32),
            uv=T(uv, np.float32), obs_valid=T(valid),
            cam_valid=T(np.arange(C) < nC), lm_valid=T(np.arange(L) < nL))
        if self.mesh is not None:
            self._run_window_ba_sharded(p, cfg, slots, lm_slots, nC, nL)
            return
        res, ev = self._readback(run_ba_packed_jit(p, cfg))
        if cfg.async_ba:
            # the solve runs on the device while the next frames track;
            # results land at the next keyframe. Snapshot identities so
            # slot recycling in between can't corrupt the write-back.
            self._pending_ba = (slots, self.map.kf_frame_id[slots].copy(),
                                lm_slots, self.map.lm_uid[lm_slots].copy(),
                                nC, nL, res, ev)
            return
        Rf, tf, Xf, cost, _ = unpack_ba_result(self._fetch((res, ev)), C, L)
        self.last_ba_cost = cost
        self.map.writeback_ba(slots, lm_slots, Rf[:nC], tf[:nC], Xf[:nL])

    def _run_window_ba_sharded(self, p: BAProblem, cfg, slots, lm_slots,
                               nC: int, nL: int) -> None:
        """Trajectory-sharded window BA over the mesh (camera blocks per
        shard, ring Schur reduce-scatter, distributed CG), synchronous as
        in the reference: the result is written back at once."""
        from visualslam_tpu_torch.parallel.traj_ba import (
            pad_cameras,
            run_ba_traj_sharded,
            shard_problem_trajectory,
            unshard_traj,
        )

        n = self.mesh.shape["shard"]
        p = pad_cameras(p, n)
        sp = shard_problem_trajectory(p, n)
        dres = run_ba_traj_sharded(sp, cfg, self.mesh)
        Rn, tn, Xn = unshard_traj(dres.R, dres.t, dres.X, sp.lm_order,
                                  int(p.X.shape[0]))
        self.last_ba_cost = float(dres.cost)
        self.map.writeback_ba(slots, lm_slots, Rn[:nC], tn[:nC], Xn[:nL])

    def _flush_pending_ba(self, wait: bool = True) -> None:
        """Apply an in-flight async window BA. With wait=False the flush is
        skipped (kept pending) while the device hasn't finished it
        (`torch.cuda.Event.query`; always finished on the CPU)."""
        if self._pending_ba is None:
            return
        slots, fids, lm_slots, uids, nC, nL, res, ev = self._pending_ba
        if not wait and ev is not None and not ev.query():
            return
        self._pending_ba = None
        Rf, tf, Xf, cost, _ = unpack_ba_result(
            self._fetch((res, ev)), self.cfg.ba.max_cameras,
            self.cfg.ba.max_landmarks)
        R, t, X = Rf[:nC], tf[:nC], Xf[:nL]
        self.last_ba_cost = cost
        # only entities that still hold the keyframe / landmark they held
        # at dispatch time
        kf_ok = self.map.kf_frame_id[slots] == fids
        lm_ok = self.map.lm_uid[lm_slots] == uids
        self.map.kf_R[slots[kf_ok]] = R[kf_ok]
        self.map.kf_t[slots[kf_ok]] = t[kf_ok]
        self.map.X[lm_slots[lm_ok]] = X[lm_ok]
        # the chain pose of the newest keyframe moved
        last = self.map.last_keyframe_slot()
        if kf_ok.any() and slots[kf_ok][-1] == last:
            self._last_R = self.map.kf_R[last].copy()
            self._last_t = self.map.kf_t[last].copy()

    # ------------------------------------------------------------------

    @_entry
    def global_ba(self, mesh=None):
        """Full-sequence bundle adjustment over the ENTIRE keyframe history
        (slam/global_ba.py). Keyframe FrameResults adopt their optimized
        poses; frames between keyframes are carried rigidly by their
        preceding keyframe's correction. As in the reference, the engine's
        device state is left as it was. With `mesh` (default: the
        tracker's), the trajectory axis is sharded across its devices."""
        from visualslam_tpu_torch.slam.global_ba import run_global_ba

        if mesh is None:
            mesh = self.mesh
        self._flush_pending_ba()
        corrected = None
        lc = self.loop_closer
        if lc is not None and lc.corrected is not None:
            corrected = {int(e.frame_id): (np.asarray(Rc), np.asarray(tc))
                         for e, (Rc, tc) in zip(lc.entries, lc.corrected)}
        res = run_global_ba(self.map, self.cfg.ba, corrected, mesh,
                            device=self.device)

        by_fid = {int(f): k for k, f in enumerate(res.frame_ids)}
        carry = None     # T_kf_old^-1 . T_kf_new of the preceding keyframe
        for fr in self.frames:
            if fr.frame_id in by_fid:
                k = by_fid[fr.frame_id]
                Rn = res.R[k].astype(np.float32)
                tn = res.t[k].astype(np.float32)
                Ri = fr.R.T
                ti = -fr.R.T @ fr.t
                carry = (Ri @ Rn, Ri @ tn + ti)
                fr.R, fr.t = Rn, tn
            elif carry is not None:
                Rc, tc = carry
                fr.R, fr.t = ((fr.R @ Rc).astype(np.float32),
                              (fr.R @ tc + fr.t).astype(np.float32))
        return res

    def trajectory(self) -> np.ndarray:
        """[F, 3, 4] camera-to-world pose matrices (KITTI convention).
        Frames up to the last pose-graph-corrected keyframe adopt the
        corrected keyframe poses, with frames between keyframes carried
        rigidly by their preceding keyframe's correction."""
        corr = None
        lc = self.loop_closer
        if lc is not None and lc.corrected is not None and lc.entries:
            corr = {int(e.frame_id): (Rc, tc)
                    for e, (Rc, tc) in zip(lc.entries, lc.corrected)}
            last_fid = max(corr)
        out = []
        carry = None
        for f in self.frames:
            R, t = f.R, f.t
            if corr is not None and f.frame_id <= last_fid:
                if f.frame_id in corr:
                    Rc, tc = corr[f.frame_id]
                    Ri, ti = R.T, -R.T @ t
                    carry = (Ri @ Rc, Ri @ tc + ti)   # T_old^-1 . T_new
                    R, t = Rc, tc
                elif carry is not None:
                    Rc2, tc2 = carry
                    R, t = R @ Rc2, R @ tc2 + t
            out.append(np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1))
        return np.stack(out)

    def keyframe_trajectory(self) -> tuple[np.ndarray, np.ndarray]:
        """(frame_ids [K], poses [K, 3, 4]) over keyframes: pose-graph-
        corrected when loop closure has run, odometry otherwise."""
        if self.loop_closer is None or not self.loop_closer.entries:
            ids = [f.frame_id for f in self.frames if f.is_keyframe]
            poses = [p for f, p in zip(self.frames, self.trajectory())
                     if f.is_keyframe]
            return np.asarray(ids), (np.stack(poses) if poses
                                     else np.zeros((0, 3, 4)))
        lc = self.loop_closer
        pairs = ([(e.R, e.t) for e in lc.entries] if lc.corrected is None
                 else lc.corrected)
        ids = np.asarray([e.frame_id for e in lc.entries])
        poses = np.stack([
            np.concatenate([R.T, (-R.T @ t)[:, None]], axis=1)
            for R, t in pairs])
        return ids, poses

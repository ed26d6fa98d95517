"""Loop-closure detection + pose-graph correction
(visualslam_tpu/slam/loop_closure.py).

  retrieval   every keyframe stores a GLOBAL descriptor (response-weighted
              sum of its local descriptors, L2-normalized); candidates are
              the best cosines against past keyframes outside a temporal
              exclusion window.
  verify      local-descriptor matching (ratio + mutual) + motion-only PnP
              of the candidate camera against the current keyframe's
              landmark snapshot (`_verify`): a detection verifies its
              top-k candidates, padded to k, in one call and one packed
              read-back; metric scale comes with it.
  correct     a pose graph over the full keyframe history (odometry edges
              + accepted loop edges, backend/pose_graph), SE(3) or Sim(3)
              (LoopConfig.sim3); the per-entry world-side corrections move
              the database and, in the tracker, the active window.

The database, the edges and the graph assembly are numpy on the host, as
in the reference; the matcher, PnP and the graph solve run on `device`.
The solve is the JAX package's program, `optimize_sim3_graph_jit` or
`optimize_pose_graph_jit` (backend/pose_graph.py): captured CUDA graphs
on the card, which `prepare` captures ahead of use. The verification is
the JAX package's verify programs, shared per (MatchConfig, Kernels):
`_shared_matcher`, `_shared_verifier` (one candidate: relocalize) and
`_shared_verifier_batch` (the candidate axis in one graph: detect), each a
utils.graphs.GraphProgram, one captured graph per shape key on the card
and the function on the CPU; `warm_verify` captures the three at the
database's shapes, as the reference compiles them at add_keyframe. The
host arrays are uploaded outside the graphs.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import List, Optional

import numpy as np
import torch

from visualslam_tpu_torch.backend.pnp import refine_pose
from visualslam_tpu_torch.backend.pose_graph import (
    PoseGraph,
    Sim3Graph,
    optimize_pose_graph_jit,
    optimize_sim3_graph_jit,
)
from visualslam_tpu_torch.geometry.camera import normalized
from visualslam_tpu_torch.models.matching import match_body, match_features
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.config import MatchConfig, PoseGraphConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.profiling import span


@dataclass
class LoopEdge:
    i: int                  # earlier keyframe index (db order)
    j: int                  # later keyframe index
    R: np.ndarray           # relative pose: T_i^-1 T_j (graph convention)
    t: np.ndarray
    num_inliers: int = 0
    scale: float = 1.0      # relative scale of the measurement (Sim(3) sm)
    rot_sigma_deg: float = 2.0  # measurement uncertainty (the mutual-PnP
    #                             rotation disagreement, engine path); drives
    #                             the information weighting in optimize()


@dataclass
class KeyframeEntry:
    frame_id: int
    R: np.ndarray            # world-to-camera at insertion (odometry frame)
    t: np.ndarray
    global_desc: np.ndarray  # [D] (None for device-resident entries)
    desc: np.ndarray         # [Ks, D] subsampled local descriptors (None:
    #                          the engine keeps them on the device)
    yx: np.ndarray           # [Ks, 2]
    lm_world: np.ndarray     # [Ks, 3] associated landmark positions
    has_lm: np.ndarray       # [Ks] bool


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _read(x: torch.Tensor) -> np.ndarray:
    """The pose graph's result on the host (a read that waits for the
    solve)."""
    with span("sync_pose_graph_read"):
        return x.cpu().numpy()


def _verify(desc_a, yx_a, has_lm_a, lm_world_a, desc_b, yx_b, R0, t0, intr,
            match_cfg: MatchConfig, kernels: Kernels) -> torch.Tensor:
    """Geometric verification on the device: match + usability gate + PnP
    of camera b against a's landmarks. Packed [1 num_inliers][9 R][3 t]
    [M usable][M idx_a][M idx_b][M pnp_inliers] (float32)."""
    k = desc_a.shape[0]
    dev = desc_a.device
    ones = torch.ones(k, dtype=torch.bool, device=dev)
    empty = Keypoints.empty(k, dev)
    fa = Features(empty._replace(yx=yx_a, valid=ones), desc_a)
    fb = Features(empty._replace(yx=yx_b, valid=ones), desc_b)
    m = match_features(fa, fb, match_cfg, kernels)
    ia, ib = m.idx_a.long(), m.idx_b.long()
    usable = m.valid & has_lm_a[ia]
    pr = refine_pose(R0, t0, lm_world_a[ia], normalized(yx_b[ib].flip(-1),
                                                        intr), usable)
    f32 = torch.float32
    return torch.cat([pr.num_inliers.to(f32)[None], pr.R.reshape(-1), pr.t,
                      usable.to(f32), m.idx_a.to(f32), m.idx_b.to(f32),
                      pr.inliers.to(f32)])


def _verify_body(x: tuple, cfg: tuple) -> torch.Tensor:
    """_shared_verifier's function: x = (desc_a, yx_a, has_lm_a,
    lm_world_a, desc_b, yx_b, R0, t0, intr), cfg = (MatchConfig,
    Kernels)."""
    return _verify(*x, *cfg)


def _verify_batch_body(x: tuple, cfg: tuple) -> torch.Tensor:
    """_shared_verifier_batch's function: `_verify` of entry a against
    each candidate c of x = (desc_a, yx_a, has_lm_a, lm_world_a, descs_b
    [C, k, D], yxs_b [C, k, 2], Rs_b [C, 3, 3], ts_b [C, 3], intr), stacked
    [C, 13 + 4 M] (the JAX package's vmap over the candidate axis)."""
    desc_a, yx_a, has_lm_a, lm_world_a, descs_b, yxs_b, Rs_b, ts_b, intr = x
    return torch.stack([
        _verify(desc_a, yx_a, has_lm_a, lm_world_a, descs_b[c], yxs_b[c],
                Rs_b[c], ts_b[c], intr, *cfg)
        for c in range(descs_b.shape[0])])


@functools.lru_cache(maxsize=32)
def _shared_matcher(match_cfg: MatchConfig, kernels: Kernels) -> GraphProgram:
    """The matcher program of a loop-closer config, called as
    program((fa, fb), (match_cfg, kernels)); shared by every LoopCloser
    with an equal config, as the reference's."""
    return GraphProgram(match_body, seeded=False)


@functools.lru_cache(maxsize=32)
def _shared_verifier(match_cfg: MatchConfig, kernels: Kernels) -> GraphProgram:
    """The fused verification of one candidate (match + usability gate +
    PnP, one packed buffer: `_verify`), called as program((desc_a, yx_a,
    has_lm_a, lm_world_a, desc_b, yx_b, R0, t0, intr), (match_cfg,
    kernels))."""
    return GraphProgram(_verify_body, seeded=False)


@functools.lru_cache(maxsize=32)
def _shared_verifier_batch(match_cfg: MatchConfig,
                           kernels: Kernels) -> GraphProgram:
    """The verification of every candidate in one graph (the candidate
    axis: descs_b, yxs_b, Rs_b, ts_b gain a leading [C]), called as
    _shared_verifier's program; detect pads its candidates to top_k, so
    one key serves any number of surviving candidates."""
    return GraphProgram(_verify_batch_body, seeded=False)


def _unpack_verify(packed: np.ndarray, M: int):
    a = np.asarray(packed)
    n_inl = int(a[0])
    R = a[1:10].reshape(3, 3)
    t = a[10:13]
    o = 13
    usable = a[o:o + M] > 0.5
    ia = a[o + M:o + 2 * M].astype(np.int64)
    ib = a[o + 2 * M:o + 3 * M].astype(np.int64)
    inl = a[o + 3 * M:o + 4 * M] > 0.5
    return n_inl, R, t, usable, ia, ib, inl


def _np_se3_relative(Ra, ta, Rb, tb):
    """T_a^-1 . T_b in numpy."""
    return Ra.T @ Rb, Ra.T @ (tb - ta)


def _np_sim3_inverse(R, t, s):
    Rt = R.T
    return Rt, -(Rt @ t) / s, 1.0 / s


def _np_sim3_compose(Ra, ta, sa, Rb, tb, sb):
    return Ra @ Rb, sa * (Ra @ tb) + ta, sa * sb


class LoopCloser:
    """Keyframe database + loop detection + pose-graph correction."""

    def __init__(self, intrinsics, match_cfg: MatchConfig,
                 pg_cfg: PoseGraphConfig, sub_keypoints: int = 256,
                 cosine_threshold: float = 0.85, min_inliers: int = 25,
                 exclude_recent: int = 10, use_sim3: bool = False,
                 max_scale: float = 1.5, device="cuda",
                 kernels: Kernels = KERNELS):
        self.device = torch.device(device)
        self.kernels = kernels
        self.intr = np.asarray(_host(intrinsics), np.float32)
        self._intr_dev = torch.as_tensor(self.intr, device=self.device)
        # entries always store float descriptors (ORB bits unpack to {0, 1}
        # floats, where L2 == 2x Hamming), so match on L2
        self.match_cfg = match_cfg.replace(max_matches=sub_keypoints,
                                           metric="l2")
        self.pg_cfg = pg_cfg
        self.sub = sub_keypoints
        self.cos_thresh = cosine_threshold
        self.min_inliers = min_inliers
        self.exclude = exclude_recent
        self.use_sim3 = use_sim3
        # the verify programs, shared per config (as the reference's)
        self._match = _shared_matcher(self.match_cfg, kernels)
        self._verifier = _shared_verifier(self.match_cfg, kernels)
        self._verifier_batch = _shared_verifier_batch(self.match_cfg, kernels)
        self._verify_warmed = False
        # the pose-graph program optimize() runs: the JAX package's
        # *_jit, replayed from captured CUDA graphs on the card
        self.program = (optimize_sim3_graph_jit if use_sim3
                        else optimize_pose_graph_jit)
        # Sim(3) scale-ratio sanity gate: estimates outside
        # [1/max_scale, max_scale] fall back to SE(3)
        self.max_scale = max_scale
        self.entries: List[KeyframeEntry] = []
        self.loop_edges: List[LoopEdge] = []
        # filled by optimize(); None until the first loop. corrected:
        # de-scaled SE(3) (R, t) per entry; corrected_scale: Sim(3) node
        # scale per entry; last_corrections: world-side Sim(3) (Rg, tg, sg)
        # per entry, pre-correction world points -> corrected ones
        self.corrected: Optional[list] = None
        self.corrected_scale: Optional[list] = None
        self.last_corrections: Optional[list] = None

    def warm_verify(self, desc_dim: int = 128) -> None:
        """Capture the verify programs at the database shapes (sub_keypoints
        x desc_dim, three candidates for detect's batch) ahead of the first
        real candidate, as the reference compiles them at add_keyframe:
        zero inputs, nothing runs (GraphProgram.prepare; nothing on the
        CPU). Once per closer."""
        if self._verify_warmed:
            return
        self._verify_warmed = True
        k, dev = self.sub, self.device

        def z(*shape):
            return torch.zeros(shape, device=dev)

        ones = torch.ones(k, dtype=torch.bool, device=dev)
        f = Features(Keypoints.empty(k, dev)._replace(valid=ones),
                     z(k, desc_dim))
        cfg = (self.match_cfg, self.kernels)
        self._match.prepare((f, f), cfg)
        a = (z(k, desc_dim), z(k, 2), ones, z(k, 3))
        eye = torch.eye(3, device=dev)
        self._verifier.prepare(a + (z(k, desc_dim), z(k, 2), eye, z(3),
                                    self._intr_dev), cfg)
        self._verifier_batch.prepare(
            a + (z(3, k, desc_dim), z(3, k, 2), eye.expand(3, 3, 3),
                 z(3, 3), self._intr_dev), cfg)

    def _T(self, x, dtype=None) -> torch.Tensor:
        # a pageable upload: on the card the host waits for the copy
        with span("sync_loop_upload"):
            return torch.as_tensor(np.asarray(x, dtype), device=self.device)

    # ------------------------------------------------------------------

    @staticmethod
    def global_descriptor(desc: np.ndarray, response: np.ndarray,
                          valid: np.ndarray) -> np.ndarray:
        w = np.where(valid, np.maximum(response, 1e-6), 0.0)
        g = (desc * w[:, None]).sum(0)
        n = np.linalg.norm(g)
        return (g / n if n > 1e-9 else g).astype(np.float32)

    @staticmethod
    def _prep_features(feats: Features):
        """(desc, valid, resp, yx) as numpy; bit-packed uint32 descriptors
        unpack to {0, 1} floats (L2 on bit vectors == 2x Hamming)."""
        desc = _host(feats.descriptors)
        if desc.dtype == np.uint32:
            desc = np.unpackbits(desc.view(np.uint8), bitorder="little"
                                 ).reshape(desc.shape[0], -1).astype(
                                     np.float32)
        else:
            desc = desc.astype(np.float32)
        kp = feats.keypoints
        return (desc, _host(kp.valid).astype(bool), _host(kp.response),
                _host(kp.yx))

    def add_keyframe(self, frame_id: int, R, t, feats: Features,
                     kp_lm: np.ndarray, lm_positions: np.ndarray) -> int:
        """Register a keyframe. kp_lm: [K] landmark index per keypoint (-1
        if none); lm_positions: the global landmark array to snapshot from.
        Returns the database index."""
        desc, valid, resp, yx = self._prep_features(feats)
        self.warm_verify(desc.shape[1])
        # landmark-bearing keypoints FIRST (then by response): verification
        # PnPs against the entry's landmarks
        score = np.where(valid, resp, -np.inf) + np.where(kp_lm >= 0, 1e6,
                                                          0.0)
        order = np.argsort(-score)[: self.sub]
        has_lm = kp_lm[order] >= 0
        self.entries.append(KeyframeEntry(
            frame_id=frame_id,
            R=np.array(R, np.float32, copy=True),
            t=np.array(t, np.float32, copy=True),
            global_desc=self.global_descriptor(desc, resp, valid),
            desc=desc[order].copy(),
            yx=yx[order].copy(),
            lm_world=lm_positions[np.maximum(kp_lm[order], 0)].astype(
                np.float32),
            has_lm=has_lm & valid[order]))
        return len(self.entries) - 1

    def add_keyframe_light(self, frame_id: int, R, t) -> int:
        """Register a keyframe whose descriptors and landmark snapshot live
        in the DEVICE database (slam/engine.py): only its pose is mirrored
        here, so indices stay aligned 1:1 with the device ring."""
        self.entries.append(KeyframeEntry(
            frame_id=frame_id,
            R=np.array(R, np.float32, copy=True),
            t=np.array(t, np.float32, copy=True),
            global_desc=None, desc=None, yx=None, lm_world=None,
            has_lm=None))
        return len(self.entries) - 1

    def add_device_edge(self, i: int, j: int, Rb: np.ndarray,
                        tb: np.ndarray, num_inliers: int, s_oc: float,
                        rot_sigma_deg: float = 2.0) -> LoopEdge:
        """Accept a loop edge verified on the device (engine promotion):
        (Rb, tb) is candidate camera i's pose in the CURRENT world frame,
        s_oc the device-estimated old/current metric ratio."""
        a = self.entries[j]
        s = float(s_oc) if self.use_sim3 else 1.0
        if not (1.0 / self.max_scale <= s <= self.max_scale):
            s = 1.0             # distrust the ratio estimate; keep SE(3)
        Rm, tm, sm = _np_sim3_compose(
            *_np_sim3_inverse(Rb, s * tb, s), a.R, a.t, 1.0)
        edge = LoopEdge(i=i, j=j, R=np.asarray(Rm), t=np.asarray(tm),
                        num_inliers=num_inliers, scale=float(sm),
                        rot_sigma_deg=max(0.5, float(rot_sigma_deg)))
        self.loop_edges.append(edge)
        return edge

    # ------------------------------------------------------------------

    def _entry_side(self, a: KeyframeEntry) -> tuple:
        """The landmark side of a verification on the device: (desc, yx,
        has_lm, lm_world) of entry a."""
        T = self._T
        return (T(a.desc), T(a.yx, np.float32), T(a.has_lm), T(a.lm_world))

    def _verify_entry(self, a: KeyframeEntry, desc_b, yx_b, R0, t0):
        """The single verifier program: camera b (desc_b, yx_b on the
        device) against entry a's landmarks, from (R0, t0)."""
        T = self._T
        return self._verifier(
            self._entry_side(a) + (desc_b, yx_b, T(R0), T(t0),
                                   self._intr_dev),
            (self.match_cfg, self.kernels))

    def detect(self, j: int, top_k: int = 3) -> Optional[LoopEdge]:
        """Try to close a loop for keyframe j against the database: the
        top-k retrieval candidates above the cosine gate are verified in
        one call of the batch verifier (padded to top_k by repeating the
        first, so one graph serves any count) and one read-back, and
        accepted in retrieval order."""
        n = len(self.entries)
        if j != n - 1 or n <= self.exclude + 1:
            return None
        cur = self.entries[j]
        if cur.global_desc is None:
            return None     # device-resident entry: the engine detects
        past = np.stack([
            e.global_desc if e.global_desc is not None
            else np.zeros_like(cur.global_desc)
            for e in self.entries[: n - self.exclude - 1]])
        sims = past @ cur.global_desc
        order = [int(i) for i in np.argsort(-sims)[: top_k]
                 if sims[i] >= self.cos_thresh
                 and self.entries[i].desc is not None]
        if not order:
            return None
        T = self._T
        cands = [self.entries[i] for i in (order + [order[0]] * top_k)
                 [:top_k]]
        packed = _host(self._verifier_batch(
            self._entry_side(cur) + (
                T(np.stack([e.desc for e in cands])),
                T(np.stack([e.yx for e in cands]), np.float32),
                T(np.stack([e.R for e in cands])),
                T(np.stack([e.t for e in cands])), self._intr_dev),
            (self.match_cfg, self.kernels)))
        for k, i in enumerate(order):
            edge = self._edge_from_packed(i, j, packed[k])
            if edge is not None:
                self.loop_edges.append(edge)
                return edge
        return None

    def _edge_from_packed(self, i: int, j: int,
                          packed: np.ndarray) -> Optional[LoopEdge]:
        """Interpret one verification; returns the accepted edge or None."""
        a = self.entries[j]
        b = self.entries[i]
        M = self.match_cfg.max_matches
        n_inl, Rb, tb, usable, ia, ib, inl = _unpack_verify(packed, M)
        if usable.sum() < self.min_inliers or n_inl < self.min_inliers:
            return None
        # relative scale s_oc = (old units) / (current units): the median
        # pairwise-distance ratio of PnP-inlier landmarks with 3D on both
        # sides, trusted only with support and a tight spread
        s_oc = 1.0
        if self.use_sim3:
            both = inl & a.has_lm[ia] & b.has_lm[ib]
            Xa = a.lm_world[ia[both]]
            Xb = b.lm_world[ib[both]]
            if Xa.shape[0] >= 10:
                n = min(Xa.shape[0], 64)
                da = np.linalg.norm(Xa[:n, None] - Xa[None, :n], axis=-1)
                db = np.linalg.norm(Xb[:n, None] - Xb[None, :n], axis=-1)
                iu = np.triu_indices(n, 1)
                da, db = da[iu], db[iu]
                ok = (da > 1e-6) & (db > 1e-6)
                if ok.sum() >= 45:
                    r = db[ok] / da[ok]
                    med = float(np.median(r))
                    q1, q3 = np.percentile(r, [25, 75])
                    if (q3 - q1) <= 0.1 * max(med, 1e-6):
                        s_oc = float(np.clip(med, 0.2, 5.0))
        if not (1.0 / self.max_scale <= s_oc <= self.max_scale):
            s_oc = 1.0          # distrust the ratio estimate; keep SE(3)
        # measurement = S_i^-1 S_j with S_i = (Rb, s_oc tb, s_oc) and
        # S_j = (a.R, a.t, 1); SE(3) when s_oc == 1
        Rm, tm, sm = _np_sim3_compose(
            *_np_sim3_inverse(Rb, s_oc * tb, s_oc), a.R, a.t, 1.0)
        return LoopEdge(i=i, j=j, R=np.asarray(Rm), t=np.asarray(tm),
                        num_inliers=n_inl, scale=float(sm))

    # ------------------------------------------------------------------

    def relocalize(self, feats: Features, top_k: int = 3,
                   cosine_threshold: Optional[float] = None
                   ) -> Optional[tuple]:
        """Pose of an UNLOCALIZED frame from the keyframe database: global-
        descriptor retrieval (no temporal exclusion) -> local matching ->
        PnP against the candidate's landmark snapshot. Returns (R, t,
        num_inliers, db_index) in the current world frame, or None."""
        if not self.entries:
            return None
        desc, valid, resp, yx = self._prep_features(feats)
        g = self.global_descriptor(desc, resp, valid)
        sims = np.stack([
            e.global_desc if e.global_desc is not None
            else np.zeros_like(g)
            for e in self.entries]) @ g
        thresh = (self.cos_thresh if cosine_threshold is None
                  else cosine_threshold)
        # query keypoints subsampled exactly like database entries
        order_kp = np.argsort(np.where(valid, -resp, np.inf))[: self.sub]
        q_desc = self._T(desc[order_kp])
        q_yx = self._T(yx[order_kp], np.float32)
        for i in np.argsort(-sims)[: top_k]:
            if sims[i] < thresh:
                break
            e = self.entries[i]
            # entry side carries the landmarks; the query camera starts at
            # the entry's (corrected) pose
            packed = self._verify_entry(e, q_desc, q_yx, e.R, e.t)
            n_inl, Rq, tq, usable, _, _, _ = _unpack_verify(
                packed.cpu().numpy(), self.match_cfg.max_matches)
            if usable.sum() < self.min_inliers:
                continue
            if n_inl >= self.min_inliers:
                return (Rq, tq, n_inl, int(i))
        return None

    # ------------------------------------------------------------------

    def _capacity(self, n: int) -> tuple[int, int]:
        """(N, E): the padded graph's nodes and edges for n entries; the
        capacity grows in powers of two past the configured floor."""
        N = self.pg_cfg.max_nodes
        while N < n:
            N *= 2
        E = self.pg_cfg.max_edges
        while E < N * 4:
            E *= 2
        return N, E

    def _graph(self, N: int, E: int, R0, t0, ii, jj, Rm, tm, sm, w):
        """The pose graph of the nodes (R0, t0) and the edges (ii, jj, Rm,
        tm, sm, w) on the device, padded to N nodes and E edges with
        identity nodes and edges: a Sim3Graph under use_sim3, else a
        PoseGraph."""
        n, ne = len(R0), len(ii)
        if ne > E:
            raise RuntimeError(
                f"pose graph edge overflow: {ne} edges > capacity {E}")

        def pad(a, target, shape_tail):
            out = np.zeros((target,) + shape_tail, np.float32)
            if len(a):
                out[: len(a)] = np.asarray(a)
            return out

        eye_fill_N = (np.tile(np.eye(3, dtype=np.float32), (N, 1, 1))
                      * (np.arange(N) >= n)[:, None, None])
        eye_fill_E = (np.tile(np.eye(3, dtype=np.float32), (E, 1, 1))
                      * (np.arange(E) >= ne)[:, None, None])
        T = self._T
        common = dict(
            node_valid=T(np.arange(N) < n),
            i=T(pad(ii, E, ()).astype(np.int64)),
            j=T(pad(jj, E, ()).astype(np.int64)),
            Rm=T(pad(Rm, E, (3, 3)) + eye_fill_E),
            tm=T(pad(tm, E, (3,))),
            weight=T(pad(w, E, ())),
            edge_valid=T(np.arange(E) < ne))
        R_in = T(pad(R0, N, (3, 3)) + eye_fill_N)
        t_in = T(pad(t0, N, (3,)))
        if self.use_sim3:
            return Sim3Graph(
                R=R_in, t=t_in, s=T(np.ones(N, np.float32)),
                sm=T(np.where(np.arange(E) < ne, pad(sm, E, ()), 1.0)
                     .astype(np.float32)), **common)
        return PoseGraph(R=R_in, t=t_in, **common)

    def prepare(self) -> None:
        """Capture the pose-graph program at the padded shapes the next
        optimize() will use (`_capacity` of the entries so far: max_nodes
        and max_edges until the history outgrows them), on the closer's
        device, without running it; nothing on the CPU. The closer's state
        is left as it was."""
        none = np.zeros((0, 3, 3), np.float32)
        g = self._graph(*self._capacity(len(self.entries)), none,
                        none[:, 0], [], [], [], [], [], [])
        self.program.prepare(g, self.pg_cfg)

    def optimize(self, propagate: bool = True) -> Optional[np.ndarray]:
        """Pose-graph optimization over the full keyframe history (SE(3) or
        Sim(3), per use_sim3). Fills corrected, corrected_scale and
        last_corrections; with `propagate` every database entry adopts its
        corrected pose and its landmark snapshot moves with the entry's own
        correction. Returns corrected camera centres [N, 3] or None."""
        n = len(self.entries)
        if n < 3:
            return None
        R0 = np.stack([e.R for e in self.entries])
        t0 = np.stack([e.t for e in self.entries])
        ii, jj, Rm, tm, sm, w = [], [], [], [], [], []
        for k in range(n - 1):
            Rr, tr = _np_se3_relative(R0[k], t0[k], R0[k + 1], t0[k + 1])
            ii.append(k)
            jj.append(k + 1)
            Rm.append(Rr)
            tm.append(tr)
            sm.append(1.0)
            w.append(1.0)
        for e in self.loop_edges:
            ii.append(e.i)
            jj.append(e.j)
            Rm.append(e.R)
            tm.append(e.t)
            sm.append(e.scale)
            # information weighting by the mutual-verification rotation
            # disagreement
            info = min(4.0, (2.0 / max(e.rot_sigma_deg, 0.5)) ** 2)
            w.append(self.pg_cfg.loop_weight * info)
        g = self._graph(*self._capacity(n), R0, t0, ii, jj, Rm, tm, sm, w)
        with span("loop_pose_graph"):
            res = self.program(g, self.pg_cfg)
            scales = (_read(res.s[:n]) if self.use_sim3
                      else np.ones(n, np.float32))
            Rn = _read(res.R[:n])
            tn = _read(res.t[:n])
        # de-scaled SE(3): x_cam_metric = R X + t / s
        self.corrected = [(Rn[k], tn[k] / scales[k]) for k in range(n)]
        self.corrected_scale = list(scales)

        # world-side correction per entry: G_k = S_new_k^-1 . S_old_k
        self.last_corrections = []
        for k in range(n):
            Rg, tg, sg = _np_sim3_compose(
                *_np_sim3_inverse(Rn[k], tn[k], float(scales[k])),
                R0[k], t0[k], 1.0)
            self.last_corrections.append(
                (np.asarray(Rg), np.asarray(tg), float(sg)))

        if propagate:
            for k, e in enumerate(self.entries):
                Rg, tg, sg = self.last_corrections[k]
                if e.lm_world is not None:      # device entries move on
                    e.lm_world = sg * (e.lm_world @ Rg.T) + tg  # the device
                Rk, tk = self.corrected[k]
                e.R = np.array(Rk, np.float32, copy=True)
                e.t = np.array(tk, np.float32, copy=True)

        return np.stack([-Rn[k].T @ tn[k] / scales[k] for k in range(n)])

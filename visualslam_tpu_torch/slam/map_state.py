"""SLAM map state: keyframes, landmarks, observations
(visualslam_tpu/slam/map_state.py).

A numpy copy: the JAX package imports jax at package import, so the port
carries its own copy of this numpy-only module (tests/test_torch_tracking.py
holds the two equal on one sequence of operations). Storage lives host-side
in numpy (slot allocation, eviction and association are branchy
bookkeeping); every device phase receives fixed-shape tensor views of it.

Landmarks carry persistent unique ids (uids) alongside their recycled slot
indices: observations are validated against the uid, so a slot reused after
eviction/wraparound can never be misattributed, and evicted keyframes are
ARCHIVED (pose + uid-keyed observations) for a full-sequence global BA."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass
class ArchivedKeyframe:
    """A keyframe evicted from the window, kept for global BA."""

    frame_id: int
    R: np.ndarray               # world-to-camera at eviction time
    t: np.ndarray
    lm_uid: np.ndarray          # [n_obs] persistent landmark ids
    uv: np.ndarray              # [n_obs, 2] normalized observations


class SlamMap:
    """Fixed-capacity sliding-window map."""

    def __init__(self, window: int, max_landmarks: int, feat_capacity: int):
        self.window = window
        self.max_landmarks = max_landmarks
        C, L = window, max_landmarks
        # keyframes (ring buffer of slots)
        self.kf_R = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        self.kf_t = np.zeros((C, 3), np.float32)
        self.kf_valid = np.zeros(C, bool)
        self.kf_frame_id = np.full(C, -1, np.int64)
        self.kf_order: list[int] = []           # slots, oldest first
        # per-keyframe features (for matching) + kp->landmark association
        self.kf_desc = [None] * C
        self.kf_yx = [None] * C
        self.kf_kp_valid = [None] * C
        self.kf_kp_lm = [np.full(feat_capacity, -1, np.int64)
                         for _ in range(C)]
        # landmarks
        self.X = np.zeros((L, 3), np.float32)
        self.lm_valid = np.zeros(L, bool)
        self.lm_obs_count = np.zeros(L, np.int32)
        self.lm_uid = np.full(L, -1, np.int64)   # persistent unique ids
        self._next_uid = 0
        self._lm_cursor = 0
        # observations: dict slot -> (lm_idx, lm_uid, uv) per keyframe
        self.obs = {}
        # full-sequence history for global BA (slam/global_ba.py)
        self.archive: list[ArchivedKeyframe] = []
        self.archived_lm_pos: dict[int, np.ndarray] = {}  # uid -> [3]

    # ---------- keyframes ----------

    def allocate_keyframe(self) -> tuple[int, int | None]:
        """Returns (slot, evicted_slot or None). Evicts the oldest keyframe
        when the window is full."""
        evicted = None
        if len(self.kf_order) == self.window:
            evicted = self.kf_order.pop(0)
            self._remove_keyframe(evicted)
        free = np.nonzero(~self.kf_valid)[0]
        slot = int(free[0])
        self.kf_order.append(slot)
        return slot, evicted

    def _remove_keyframe(self, slot: int) -> None:
        if slot in self.obs:
            lm_idx, lm_uid, uv = self.obs.pop(slot)
            # archive: keep only observations whose slot still holds the
            # same landmark (uid match) — stale ones are meaningless
            live = self.lm_uid[lm_idx] == lm_uid
            self.archive.append(ArchivedKeyframe(
                frame_id=int(self.kf_frame_id[slot]),
                R=self.kf_R[slot].copy(), t=self.kf_t[slot].copy(),
                lm_uid=lm_uid[live].copy(), uv=uv[live].copy()))
            np.subtract.at(self.lm_obs_count, lm_idx[live], 1)
        else:
            self.archive.append(ArchivedKeyframe(
                frame_id=int(self.kf_frame_id[slot]),
                R=self.kf_R[slot].copy(), t=self.kf_t[slot].copy(),
                lm_uid=np.zeros(0, np.int64),
                uv=np.zeros((0, 2), np.float32)))
        self.kf_valid[slot] = False
        self.kf_frame_id[slot] = -1
        self.kf_desc[slot] = None
        self.kf_yx[slot] = None
        self.kf_kp_valid[slot] = None
        self.kf_kp_lm[slot][:] = -1
        # free landmarks nobody observes anymore; snapshot their positions
        # for the global-BA initialization
        dead = self.lm_valid & (self.lm_obs_count <= 0)
        for s in np.nonzero(dead)[0]:
            self.archived_lm_pos[int(self.lm_uid[s])] = self.X[s].copy()
        self.lm_valid[dead] = False

    def set_keyframe(self, slot: int, frame_id: int, R, t, desc, yx,
                     kp_valid) -> None:
        self.kf_R[slot] = R
        self.kf_t[slot] = t
        self.kf_valid[slot] = True
        self.kf_frame_id[slot] = frame_id
        # host copy: the local-map rebuild gathers descriptors per keyframe
        # on every keyframe insertion — one device->host transfer here beats
        # repeated readbacks there. Engine-mode keyframes (slam/engine.py)
        # keep descriptors device-resident and pass None.
        self.kf_desc[slot] = None if desc is None else np.asarray(desc)
        self.kf_yx[slot] = yx
        self.kf_kp_valid[slot] = kp_valid
        self.kf_kp_lm[slot][:] = -1

    def last_keyframe_slot(self) -> int:
        return self.kf_order[-1]

    # ---------- landmarks ----------

    def allocate_landmarks(self, X_new: np.ndarray) -> np.ndarray:
        """Allocate len(X_new) landmark slots (free slots first, then
        overwrite-oldest wraparound). Returns the slot indices."""
        n = len(X_new)
        free = np.nonzero(~self.lm_valid)[0]
        if len(free) >= n:
            idx = free[:n]
        else:  # wraparound: steal from the cursor onwards
            extra = n - len(free)
            steal = (self._lm_cursor + np.arange(extra)) % self.max_landmarks
            self._lm_cursor = int((self._lm_cursor + extra)
                                  % self.max_landmarks)
            idx = np.concatenate([free, steal])
        # snapshot positions of landmarks whose slots get recycled
        for s in idx:
            if self.lm_uid[s] >= 0:
                self.archived_lm_pos[int(self.lm_uid[s])] = self.X[s].copy()
        self.X[idx] = X_new
        self.lm_valid[idx] = True
        self.lm_obs_count[idx] = 0
        self.lm_uid[idx] = self._next_uid + np.arange(n)
        self._next_uid += n
        return idx

    def add_observations(self, slot: int, lm_idx: np.ndarray,
                         uv: np.ndarray) -> None:
        """Record that keyframe `slot` observes lm_idx at normalized uv."""
        lm_idx = np.asarray(lm_idx, np.int64)
        lm_uid = self.lm_uid[lm_idx].copy()
        np.add.at(self.lm_obs_count, lm_idx, 1)
        if slot in self.obs:
            old_lm, old_uid, old_uv = self.obs[slot]
            lm_idx = np.concatenate([old_lm, lm_idx])
            lm_uid = np.concatenate([old_uid, lm_uid])
            uv = np.concatenate([old_uv, uv])
        self.obs[slot] = (lm_idx.astype(np.int64), lm_uid,
                          uv.astype(np.float32))

    # ---------- BA problem extraction ----------

    def build_ba_arrays(self, max_obs: int):
        """Flatten window observations into fixed-capacity BA arrays.

        Returns (cam_slot_map [C_active], R, t, lm_slots [L_active], X,
        cam_idx, lm_idx, uv, obs_valid) with lm/cam indices COMPACTED to the
        active sets. Host-side numpy."""
        slots = [s for s in self.kf_order if self.kf_valid[s]]
        cam_of_slot = {s: i for i, s in enumerate(slots)}
        lm_used = set()
        cams, lms, uvs = [], [], []
        for s in slots:
            if s not in self.obs:
                continue
            lm_idx, lm_uid, uv = self.obs[s]
            # valid AND still the same landmark (slot not recycled since)
            keep = self.lm_valid[lm_idx] & (self.lm_uid[lm_idx] == lm_uid)
            lm_idx = lm_idx[keep]
            uv = uv[keep]
            cams.append(np.full(len(lm_idx), cam_of_slot[s]))
            lms.append(lm_idx)
            uvs.append(uv)
            lm_used.update(lm_idx.tolist())
        lm_slots = np.asarray(sorted(lm_used), np.int64)
        lm_remap = {g: i for i, g in enumerate(lm_slots.tolist())}
        cam_idx = np.concatenate(cams) if cams else np.zeros(0, np.int64)
        lm_idx = (np.asarray([lm_remap[g] for g in np.concatenate(lms)])
                  if lms else np.zeros(0, np.int64))
        uv = np.concatenate(uvs) if uvs else np.zeros((0, 2), np.float32)

        O = min(len(cam_idx), max_obs)
        order = np.arange(len(cam_idx))
        if len(cam_idx) > max_obs:  # keep the newest observations
            order = order[-max_obs:]
        pad = max_obs - O
        cam_out = np.concatenate([cam_idx[order], np.zeros(pad, np.int64)])
        lm_out = np.concatenate([lm_idx[order], np.zeros(pad, np.int64)])
        uv_out = np.concatenate([uv[order], np.zeros((pad, 2), np.float32)])
        valid = np.concatenate([np.ones(O, bool), np.zeros(pad, bool)])
        return (np.asarray(slots), self.kf_R[slots], self.kf_t[slots],
                lm_slots, self.X[lm_slots], cam_out, lm_out, uv_out, valid)

    def writeback_ba(self, slots, lm_slots, R, t, X) -> None:
        self.kf_R[slots] = R
        self.kf_t[slots] = t
        self.X[lm_slots] = X

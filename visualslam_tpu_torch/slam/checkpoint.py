"""Checkpoint / resume of the SLAM state (visualslam_tpu/slam/checkpoint.py).

Format: a single .npz with every SlamMap array, per-keyframe feature blobs,
the tracker's scalars and, in engine mode, the device-resident engine state
(`eng_*`): the same keys, shapes and dtypes as the JAX package writes, so a
checkpoint of one package has the other's layout. Tensors are fetched to
numpy field by field before `np.savez_compressed`; on load they go to the
tracker's device. As in the reference, the loop-closure cooldown is not
saved (reference defect 5, ROADMAP.md C). One addition: once a loop has
closed, the pose-graph-corrected poses (`lc_corr_R`, `lc_corr_t`,
`lc_corr_s`), which the reference does not save (reference defect 6), so
that a resumed tracker's trajectory and global BA start from them as the
original's do; before any closure the key set is the reference's.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def save_checkpoint(path: str, tracker) -> None:
    if hasattr(tracker, "_flush_pending_ba"):
        tracker._flush_pending_ba()     # land any in-flight async window BA
    m = tracker.map
    blobs = {}
    for s in range(m.window):
        if m.kf_desc[s] is not None:
            blobs[f"kf_desc_{s}"] = _np(m.kf_desc[s])
            blobs[f"kf_yx_{s}"] = _np(m.kf_yx[s])
            blobs[f"kf_kp_valid_{s}"] = _np(m.kf_kp_valid[s])
        blobs[f"kf_kp_lm_{s}"] = m.kf_kp_lm[s]
        if s in m.obs:
            (blobs[f"obs_lm_{s}"], blobs[f"obs_uid_{s}"],
             blobs[f"obs_uv_{s}"]) = m.obs[s]
    for k, a in enumerate(m.archive):
        blobs[f"arch_meta_{k}"] = np.concatenate(
            [[a.frame_id], a.R.ravel(), a.t]).astype(np.float64)
        blobs[f"arch_uid_{k}"] = a.lm_uid
        blobs[f"arch_uv_{k}"] = a.uv
    if m.archived_lm_pos:
        blobs["alp_uid"] = np.asarray(list(m.archived_lm_pos.keys()),
                                      np.int64)
        blobs["alp_pos"] = np.stack(list(m.archived_lm_pos.values()))
    # the engine's device state (slam/engine.py): keyframe reference, local
    # map and loop database, so a resumed run re-enters the engine with its
    # full context. Database rings are sliced to the live entry count.
    if getattr(tracker, "_eng_persist", None) is not None:
        n = int(tracker._eng_db_n)
        for name, arr in tracker._eng_persist._asdict().items():
            a = _np(arr)
            if name.startswith("db_") and a.ndim >= 1 and name != "db_n":
                a = a[:n]
            blobs[f"eng_{name}"] = a
        blobs["eng_db_n"] = np.int64(n)
        blobs["eng_ids"] = tracker._eng_ids
        blobs["eng_uids"] = tracker._eng_uids
        blobs["eng_gen"] = tracker._eng_gen
    lc = getattr(tracker, "loop_closer", None)
    if lc is not None and lc.entries:
        blobs["lc_fids"] = np.asarray([e.frame_id for e in lc.entries],
                                      np.int64)
        blobs["lc_R"] = np.stack([e.R for e in lc.entries])
        blobs["lc_t"] = np.stack([e.t for e in lc.entries])
        if lc.loop_edges:
            blobs["lc_edges"] = np.stack([
                np.concatenate([[e.i, e.j, e.num_inliers, e.scale],
                                e.R.ravel(), e.t]).astype(np.float64)
                for e in lc.loop_edges])
        if lc.corrected is not None:
            blobs["lc_corr_R"] = np.stack([R for R, _ in lc.corrected])
            blobs["lc_corr_t"] = np.stack([t for _, t in lc.corrected])
            blobs["lc_corr_s"] = np.asarray(lc.corrected_scale, np.float32)
    frames = np.array(
        [(f.frame_id, f.num_matches, f.num_inliers, int(f.is_keyframe),
          int(f.tracking_ok)) for f in tracker.frames], np.int64)
    frame_R = np.stack([f.R for f in tracker.frames]) if tracker.frames \
        else np.zeros((0, 3, 3), np.float32)
    frame_t = np.stack([f.t for f in tracker.frames]) if tracker.frames \
        else np.zeros((0, 3), np.float32)
    np.savez_compressed(
        path,
        kf_R=m.kf_R, kf_t=m.kf_t, kf_valid=m.kf_valid,
        kf_frame_id=m.kf_frame_id, kf_order=np.asarray(m.kf_order, np.int64),
        X=m.X, lm_valid=m.lm_valid, lm_obs_count=m.lm_obs_count,
        lm_uid=m.lm_uid, next_uid=np.int64(m._next_uid),
        n_archive=np.int64(len(m.archive)),
        lm_cursor=np.int64(m._lm_cursor),
        frames=frames, frame_R=frame_R, frame_t=frame_t,
        last_R=tracker._last_R, last_t=tracker._last_t, vel=tracker._vel,
        frames_since_kf=np.int64(tracker._frames_since_kf),
        **blobs,
    )


def load_checkpoint(path: str, tracker) -> None:
    """Restore state saved by save_checkpoint into a freshly constructed
    Tracker (same config); device arrays go to `tracker.device`."""
    from visualslam_tpu_torch.slam.map_state import ArchivedKeyframe
    from visualslam_tpu_torch.slam.tracker import FrameResult

    dev = tracker.device
    z = np.load(path, allow_pickle=False)
    m = tracker.map
    m.kf_R = z["kf_R"].copy()
    m.kf_t = z["kf_t"].copy()
    m.kf_valid = z["kf_valid"].copy()
    m.kf_frame_id = z["kf_frame_id"].copy()
    m.kf_order = [int(s) for s in z["kf_order"]]
    m.X = z["X"].copy()
    m.lm_valid = z["lm_valid"].copy()
    m.lm_obs_count = z["lm_obs_count"].copy()
    m._lm_cursor = int(z["lm_cursor"])
    if "lm_uid" in z:
        m.lm_uid = z["lm_uid"].copy()
        m._next_uid = int(z["next_uid"])
        for k in range(int(z["n_archive"])):
            meta = z[f"arch_meta_{k}"]
            m.archive.append(ArchivedKeyframe(
                frame_id=int(meta[0]),
                R=meta[1:10].reshape(3, 3).astype(np.float32),
                t=meta[10:13].astype(np.float32),
                lm_uid=z[f"arch_uid_{k}"].copy(),
                uv=z[f"arch_uv_{k}"].copy()))
        if "alp_uid" in z:
            m.archived_lm_pos = {
                int(u): p for u, p in zip(z["alp_uid"], z["alp_pos"])}
    for s in range(m.window):
        m.kf_kp_lm[s] = z[f"kf_kp_lm_{s}"].copy()
        if f"kf_desc_{s}" in z:
            m.kf_desc[s] = z[f"kf_desc_{s}"].copy()
            m.kf_yx[s] = z[f"kf_yx_{s}"].copy()
            m.kf_kp_valid[s] = z[f"kf_kp_valid_{s}"].copy()
        if f"obs_lm_{s}" in z:
            m.obs[s] = (z[f"obs_lm_{s}"].copy(), z[f"obs_uid_{s}"].copy(),
                        z[f"obs_uv_{s}"].copy())
    tracker.frames = [
        FrameResult(frame_id=int(fid), R=R, t=t, num_matches=int(nm),
                    num_inliers=int(ni), is_keyframe=bool(kf),
                    tracking_ok=bool(ok))
        for (fid, nm, ni, kf, ok), R, t in zip(
            z["frames"], z["frame_R"], z["frame_t"])
    ]
    tracker._last_R = z["last_R"].copy()
    tracker._last_t = z["last_t"].copy()
    tracker._vel = z["vel"].copy()
    tracker._frames_since_kf = int(z["frames_since_kf"])
    lc = getattr(tracker, "loop_closer", None)
    if lc is not None and "lc_fids" in z:
        from visualslam_tpu_torch.slam.loop_closure import LoopEdge

        for fid, R, t in zip(z["lc_fids"], z["lc_R"], z["lc_t"]):
            lc.add_keyframe_light(int(fid), R, t)
        if "lc_edges" in z:
            for row in z["lc_edges"]:
                lc.loop_edges.append(LoopEdge(
                    i=int(row[0]), j=int(row[1]),
                    R=row[4:13].reshape(3, 3).astype(np.float32),
                    t=row[13:16].astype(np.float32),
                    num_inliers=int(row[2]), scale=float(row[3])))
        if "lc_corr_R" in z:
            lc.corrected = [(R.copy(), t.copy()) for R, t in
                            zip(z["lc_corr_R"], z["lc_corr_t"])]
            lc.corrected_scale = list(z["lc_corr_s"])
    if "eng_kf_desc" in z and getattr(tracker, "engine", False):
        from visualslam_tpu_torch.slam.engine import EnginePersist

        CAP = tracker.cfg.loop.db_capacity
        n = int(z["eng_db_n"])
        fields = {}
        for name in EnginePersist._fields:
            a = z[f"eng_{name}"]
            if name.startswith("db_") and name != "db_n":
                full = np.zeros((CAP,) + a.shape[1:], a.dtype)
                if name == "db_R":
                    # a fresh ring's fill (engine.build_persist_from_host),
                    # where the reference pads zeros: the resumed state is
                    # then the saved one bit for bit
                    full[:] = np.eye(3, dtype=a.dtype)
                full[:n] = a
                a = full
            if name == "db_n":
                # the key holds the host's int64 entry count (it is written
                # after the field, as the reference writes it); the field
                # is int32
                a = a.astype(np.int32)
            fields[name] =torch.from_numpy(np.array(a)).to(dev)
        tracker._eng_persist = EnginePersist(**fields)
        tracker._eng_ids = z["eng_ids"].copy()
        tracker._eng_uids = z["eng_uids"].copy()
        tracker._eng_gen = z["eng_gen"].copy()
        tracker._eng_db_n = n
        tracker._eng_ready = True
    # rebuild the previous-feature cache from the last keyframe
    if m.kf_order:
        s = m.kf_order[-1]
        if m.kf_desc[s] is not None:
            from visualslam_tpu_torch.models.types import Features, Keypoints

            k = m.kf_desc[s].shape[0]
            kps = Keypoints.empty(k, device=dev)._replace(
                yx=torch.as_tensor(m.kf_yx[s], device=dev),
                valid=torch.as_tensor(m.kf_kp_valid[s], device=dev))
            tracker._prev_feats = Features(
                kps, torch.as_tensor(m.kf_desc[s], device=dev))
            # device-side caches for the tracking step
            tracker._refresh_device_cache()

"""The port's checkpoint / resume (slam/checkpoint.py): the reference's
round-trip contract (tests/test_io.py) on the host path, an engine-mode
round trip of the device state, and the JAX package's checkpoint layout
on the replayed two-package scene of tests/test_torch_tracker.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_tracker import (  # noqa: F401  (replayed is a fixture)
    PCFG,
    jax_features,
    port_features,
    replayed,
)
from tracker_scene import CFG, INTR, SyntheticScene
from visualslam_tpu.slam.checkpoint import save_checkpoint as jsave
from visualslam_tpu.slam.tracker import Tracker as JTracker
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.slam.checkpoint import load_checkpoint, save_checkpoint
from visualslam_tpu_torch.slam.engine import EnginePersist
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.utils.config import SlamConfig


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs (the suite runs files in
    parallel worker processes)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stack(fs) -> Features:
    return Features(Keypoints(*(torch.stack(x) for x in zip(
        *(f.keypoints for f in fs)))), torch.stack([f.descriptors for f in fs]))


def _assert_maps_equal(a, b):
    for name in ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "X", "lm_valid",
                 "lm_obs_count", "lm_uid"):
        np.testing.assert_array_equal(getattr(a, name), getattr(b, name),
                                      err_msg=name)
    assert a.kf_order == b.kf_order
    assert (a._next_uid, a._lm_cursor) == (b._next_uid, b._lm_cursor)
    assert sorted(a.obs) == sorted(b.obs)
    for s in a.obs:
        for x, y in zip(a.obs[s], b.obs[s]):
            np.testing.assert_array_equal(x, y)
    for s in range(a.window):
        np.testing.assert_array_equal(a.kf_kp_lm[s], b.kf_kp_lm[s])
    assert len(a.archive) == len(b.archive)
    assert sorted(a.archived_lm_pos) == sorted(b.archived_lm_pos)


def _assert_frames_equal(fa, fb):
    assert len(fa) == len(fb)
    for x, y in zip(fa, fb):
        assert (x.frame_id, x.num_matches, x.num_inliers, x.is_keyframe,
                x.tracking_ok) == (y.frame_id, y.num_matches, y.num_inliers,
                                   y.is_keyframe, y.tracking_ok)
        np.testing.assert_array_equal(x.R, y.R)
        np.testing.assert_array_equal(x.t, y.t)


def test_checkpoint_roundtrip_host_path(tmp_path, rng):
    """tests/test_io.py's contract on the port: equal map, equal frames,
    and both trackers continue identically (within 1e-5)."""
    scene = SyntheticScene(rng)
    t1 = Tracker(PCFG, INTR, device="cpu")
    for k in range(8):
        feats, _ = scene.features(k)
        t1.process_features(port_features(feats), k)
    p = str(tmp_path / "ckpt.npz")
    save_checkpoint(p, t1)

    t2 = Tracker(PCFG, INTR, device="cpu")
    load_checkpoint(p, t2)
    _assert_maps_equal(t2.map, t1.map)
    _assert_frames_equal(t2.frames, t1.frames)
    assert t2._prev_feats.descriptors.device.type == "cpu"
    assert t2.loop_closer.corrected is None
    assert "lc_corr_R" not in np.load(p).files
    for k in range(8, 12):
        feats, _ = scene.features(k)
        r1 = t1.process_features(port_features(feats), k)
        r2 = t2.process_features(port_features(feats), k)
        np.testing.assert_allclose(r1.t, r2.t, atol=1e-5)
        assert r1.is_keyframe == r2.is_keyframe


def test_checkpoint_roundtrip_engine_mode(tmp_path):
    """Engine mode: the device state round-trips bit for bit with its
    dtypes (the db rings sliced to the live entries and padded back), and
    the resumed tracker runs the next engine batch exactly as the
    original does (the CPU is deterministic)."""
    scene = SyntheticScene(np.random.default_rng(5), n_points=700,
                           max_depth=45.0)
    feats = [port_features(scene.features(k)[0]) for k in range(28)]
    t1 = Tracker(PCFG, INTR, device="cpu")
    for k in range(4):
        t1.process_features(feats[k], k)
    for k in (4, 12):
        t1.process_batch_features(_stack(feats[k:k + 8]), k, 0, 8)
    assert t1._eng_persist is not None and t1._eng_db_n > 0
    p = str(tmp_path / "eng.npz")
    save_checkpoint(p, t1)
    z = np.load(p)
    assert z["eng_db_g"].shape[0] == t1._eng_db_n
    assert z["eng_kf_valid"].dtype == np.bool_
    assert z["eng_since_kf"].dtype == np.int32

    t2 = Tracker(PCFG, INTR, device="cpu")
    load_checkpoint(p, t2)
    for name in EnginePersist._fields:
        a = getattr(t1._eng_persist, name)
        b = getattr(t2._eng_persist, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        assert torch.equal(a, b), name
    for name in ("_eng_ids", "_eng_uids", "_eng_gen"):
        np.testing.assert_array_equal(getattr(t1, name), getattr(t2, name))
    assert t2._eng_db_n == t1._eng_db_n and t2._eng_ready
    _assert_maps_equal(t2.map, t1.map)
    _assert_frames_equal(t2.frames, t1.frames)

    nxt = _stack(feats[20:28])
    r1 = t1.process_batch_features(nxt, 20, 0, 8)
    r2 = t2.process_batch_features(nxt, 20, 0, 8)
    _assert_frames_equal(r2, r1)
    _assert_maps_equal(t2.map, t1.map)
    for name in EnginePersist._fields:
        assert torch.equal(getattr(t1._eng_persist, name),
                           getattr(t2._eng_persist, name)), name


def test_checkpoint_keeps_the_loop_corrected_poses(tmp_path, rng):
    """After a loop closure the pose-graph-corrected poses are saved (the
    reference loses them): the resumed tracker's trajectory and its
    global-BA problem equal the original's."""
    from visualslam_tpu_torch.slam.global_ba import build_global_problem

    scene = SyntheticScene(rng)
    t1 = Tracker(PCFG, INTR, device="cpu")
    for k in range(10):
        t1.process_features(port_features(scene.features(k)[0]), k)
    lc = t1.loop_closer
    n = len(lc.entries)
    assert n >= 3
    # a closure edge from the last entry back to the first, measured a
    # little off the odometry (as a drifted loop is)
    e0, e1 = lc.entries[0], lc.entries[-1]
    R = e0.R @ e1.R.T
    t = e0.R @ (-e1.R.T @ e1.t) + e0.t + np.float32(0.05)
    lc.add_device_edge(0, n - 1, R.astype(np.float32),
                       t.astype(np.float32), 60, 1.0)
    lc.optimize()
    assert lc.corrected is not None
    p = str(tmp_path / "loop.npz")
    save_checkpoint(p, t1)
    t2 = Tracker(PCFG, INTR, device="cpu")
    load_checkpoint(p, t2)
    for (Ra, ta), (Rb, tb) in zip(t1.loop_closer.corrected,
                                  t2.loop_closer.corrected):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)
    np.testing.assert_array_equal(t2.trajectory(), t1.trajectory())
    corr = {int(e.frame_id): c for e, c in zip(lc.entries, lc.corrected)}
    corr2 = {int(e.frame_id): c for e, c in zip(t2.loop_closer.entries,
                                                t2.loop_closer.corrected)}
    pa, _ = build_global_problem(t1.map, corr, device="cpu")
    pb, _ = build_global_problem(t2.map, corr2, device="cpu")
    for name in pa._fields:
        assert torch.equal(getattr(pa, name), getattr(pb, name)), name


FRAMES = 20


def test_checkpoint_has_the_jax_layout(tmp_path, replayed):  # noqa: F811
    """Both packages track the same injected features (the reference's
    RANSAC samples replayed, engine batches of 8) and save a checkpoint:
    the same keys and dtypes, and the same shapes for every array whose
    size the configuration fixes (the rest hold per-landmark lists, whose
    lengths part by the two-view init's float32 band)."""
    cfg = CFG.replace(ba=CFG.ba.replace(async_ba=False))
    pcfg = SlamConfig.from_json(cfg.to_json())
    scene = SyntheticScene(np.random.default_rng(11), n_points=600,
                           max_depth=0.45 * FRAMES + 30.0)
    feats = [scene.features(k)[0] for k in range(FRAMES)]
    jt = JTracker(cfg, INTR)
    pt = Tracker(pcfg, INTR, device="cpu")
    for k in range(4):
        jt.process_features(jax_features(feats[k]), k)
        pt.process_features(port_features(feats[k]), k)
    for k in range(4, FRAMES, 8):
        fj = [jax_features(f) for f in feats[k:k + 8]]
        jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *fj)
        jt.process_batch_features(jb, k, 0, len(fj))
        pt.process_batch_features(
            _stack([port_features(f) for f in feats[k:k + 8]]), k, 0,
            len(fj))
    pj, pp = str(tmp_path / "jax.npz"), str(tmp_path / "port.npz")
    jsave(pj, jt)
    save_checkpoint(pp, pt)
    zj, zp = np.load(pj), np.load(pp)
    assert any(k.startswith("eng_") for k in zj.files)
    assert sorted(zp.files) == sorted(zj.files)
    varying = ("obs_", "arch_uid_", "arch_uv_", "alp_", "eng_db_")
    for k in zj.files:
        assert zp[k].dtype == zj[k].dtype, k
        if k.startswith(varying) or k == "frames":
            assert zp[k].shape[1:] == zj[k].shape[1:], k
        else:
            assert zp[k].shape == zj[k].shape, k

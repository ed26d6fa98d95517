"""The port's Tracker on the CPU: the reference's tracker contracts
(tests/test_tracker.py) on the injected-feature scene and on rendered
frames, and one parity test that runs the same injected features through
the JAX package's Tracker and the port's, with the reference's RANSAC
samples replayed into the port."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracker_scene import CFG, INTR, SyntheticScene, garbage, gt_pose
from visualslam_tpu.geometry import ransac as jrs
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.slam.tracker import Tracker as JTracker
from visualslam_tpu_torch.geometry import ransac as trs
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.parallel.mesh import make_mesh
from visualslam_tpu_torch.slam.evaluation import (
    ate_rmse,
    centers_from_poses,
    rpe,
    umeyama_alignment,
)
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.utils.config import SlamConfig

PCFG = SlamConfig.from_json(CFG.to_json())

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def port_features(f) -> Features:
    yx, desc, valid = f
    kps = Keypoints.empty(len(valid))._replace(yx=torch.tensor(yx),
                                               valid=torch.tensor(valid))
    return Features(kps, torch.tensor(desc))


def jax_features(f) -> JFeatures:
    yx, desc, valid = f
    kps = JKeypoints.empty(len(valid))._replace(yx=jnp.asarray(yx),
                                                valid=jnp.asarray(valid))
    return JFeatures(kps, jnp.asarray(desc))


def run_sequence(rng, n_frames=16, pix_noise=0.3, cfg=PCFG, **tracker_kw):
    # cloud depth + density sized to the trajectory length
    scene = SyntheticScene(rng, n_points=max(600, 14 * n_frames),
                           max_depth=max(40.0, 0.45 * n_frames + 30.0))
    tracker = Tracker(cfg, INTR, device="cpu", **tracker_kw)
    gt = []
    for k in range(n_frames):
        f, (R, t) = scene.features(k, pix_noise=pix_noise)
        tracker.process_features(port_features(f), k)
        gt.append(gt_pose(R, t))
    return tracker, np.stack(gt)


def _ate(tracker, gt):
    return ate_rmse(centers_from_poses(tracker.trajectory()),
                    centers_from_poses(gt))


def test_tracker_bootstrap_and_init(rng):
    tracker, _ = run_sequence(rng, n_frames=4)
    assert tracker.frames[0].is_keyframe
    assert tracker.map.lm_valid.sum() > 100, "two-view init failed"
    assert len(tracker.map.kf_order) >= 2


def test_tracker_trajectory_accuracy(rng):
    tracker, gt = run_sequence(rng, n_frames=16)
    ok = [f.tracking_ok for f in tracker.frames]
    assert all(ok), f"tracking lost at frames {np.nonzero(~np.array(ok))[0]}"
    assert _ate(tracker, gt) < 0.15
    _, r_rmse = rpe(tracker.trajectory(), gt)
    assert r_rmse < 0.5, f"RPE rot {r_rmse:.3f} deg"


@pytest.mark.parametrize("solver", ["schur_cg", "schur_mf"])
def test_tracker_window_ba_under_cg_solvers(rng, monkeypatch, solver):
    """The tracker's window BA runs cfg.ba as the reference does, the two
    CG solvers included (they raised before they were ported): every
    window BA takes the configured solver, and the trajectory keeps the
    band of test_tracker_trajectory_accuracy."""
    from visualslam_tpu_torch.slam import tracker as tmod

    seen = []
    packed = tmod.run_ba_packed

    def spy(p, cfg):
        seen.append(cfg.solver)
        return packed(p, cfg)

    monkeypatch.setattr(tmod, "run_ba_packed", spy)
    cfg = PCFG.replace(ba=PCFG.ba.replace(solver=solver))
    tracker, gt = run_sequence(rng, n_frames=16, cfg=cfg)
    assert seen and set(seen) == {solver}
    assert tracker.last_ba_cost >= 0
    assert all(f.tracking_ok for f in tracker.frames)
    assert _ate(tracker, gt) < 0.15
    _, r_rmse = rpe(tracker.trajectory(), gt)
    assert r_rmse < 0.5, f"RPE rot {r_rmse:.3f} deg"


def test_tracker_window_slides(rng):
    tracker, gt = run_sequence(rng, n_frames=40)
    assert len(tracker.map.kf_order) <= CFG.ba.max_cameras
    n_kf = sum(f.is_keyframe for f in tracker.frames)
    assert n_kf > CFG.ba.max_cameras, "window never slid"
    assert _ate(tracker, gt) < 0.5


def test_tracker_ba_helps_under_noise(rng):
    """At 1.5 px noise, windowed BA improves (or at least does not
    meaningfully hurt) the trajectory against pure PnP odometry."""
    t_ba, gt = run_sequence(rng, n_frames=12, pix_noise=1.5, run_ba=True)
    t_no, _ = run_sequence(np.random.default_rng(0), n_frames=12,
                           pix_noise=1.5, run_ba=False)
    a_ba, a_no = _ate(t_ba, gt), _ate(t_no, gt)
    assert a_ba < 0.2 and a_no < 0.3, (a_ba, a_no)
    assert a_ba <= a_no * 1.2 + 0.02, (a_ba, a_no)


def test_keyframe_trajectory_export(rng):
    tracker, _ = run_sequence(rng, n_frames=12)
    ids, poses = tracker.keyframe_trajectory()
    assert len(ids) == len(poses) > 2
    assert poses.shape[1:] == (3, 4)
    assert (np.diff(ids) > 0).all()


def test_tracking_loss_recovery(rng):
    """Sustained tracking loss (garbage frames) triggers re-initialization;
    tracking resumes once real frames return."""
    scene = SyntheticScene(rng)
    tracker = Tracker(PCFG, INTR, device="cpu")
    for k in range(6):
        f, _ = scene.features(k)
        tracker.process_features(port_features(f), k)
    for k in range(6, 14):
        tracker.process_features(port_features(garbage(rng, scene.cap)), k)
    assert tracker.relocalizations >= 1, "never re-initialized"
    ok_after = []
    for k in range(14, 26):
        f, _ = scene.features(k)
        ok_after.append(tracker.process_features(port_features(f),
                                                 k).tracking_ok)
    assert any(ok_after[3:]), "tracking never recovered after re-init"
    assert tracker.map.lm_valid.sum() > 50, "map not rebuilt"


def test_async_ba_matches_sync():
    """async_ba defers the window-BA write-back by one keyframe; the
    trajectory stays close to the synchronous one."""
    cfg_async = PCFG.replace(ba=PCFG.ba.replace(async_ba=True))
    scene = SyntheticScene(np.random.default_rng(3))
    t_sync = Tracker(PCFG, INTR, device="cpu")
    t_async = Tracker(cfg_async, INTR, device="cpu")
    gt = []
    for k in range(14):
        f, (R, t) = scene.features(k)
        t_sync.process_features(port_features(f), k)
        t_async.process_features(port_features(f), k)
        gt.append(gt_pose(R, t))
    gt = np.stack(gt)
    a_sync, a_async = _ate(t_sync, gt), _ate(t_async, gt)
    assert a_async < max(2.0 * a_sync, 0.05), (a_sync, a_async)
    assert t_async.last_ba_cost >= 0


def test_tracker_100_frame_ate_regression(rng):
    """Pinned sequence-scale accuracy: 100 frames of the injected-feature
    scene, local-map tracking + windowed BA; the reference's bound."""
    tracker, gt = run_sequence(rng, n_frames=100)
    ok = [f.tracking_ok for f in tracker.frames]
    assert np.mean(ok) > 0.97, "tracking lost"
    inl = np.asarray([f.num_inliers for f in tracker.frames[2:]])
    q = len(inl) // 4
    assert inl[-q:].mean() > 0.5 * inl[:q].mean(), (
        inl[:q].mean(), inl[-q:].mean())
    ate = _ate(tracker, gt)
    assert ate < 0.8, f"100-frame ATE regression: {ate:.3f}"


# ---------------------------------------------------------------------
# rendered frames through the port's frontend (no 2x upsample and 2
# octaves, for the CPU's time; tests/test_torch_reference_profile.py runs
# the DEFAULT profile's)
# ---------------------------------------------------------------------

RCFG = PCFG.replace(
    pyramid=PCFG.pyramid.replace(num_octaves=2, initial_upsample=False),
    sift=PCFG.sift.replace(max_keypoints_per_octave=256, max_keypoints=512))


def _frames(n):
    seq = SyntheticSequence(num_frames=n, h=120, w=160, n_dots=400)
    return seq, np.stack([seq.frame(k) for k in range(n)])


def test_process_batch_equals_sequential():
    """Batched detection + tracking against per-frame processing: the same
    keypoints (>= 95% within half a pixel) and the same trajectory up to
    near-tie amplification."""
    seq, imgs = _frames(8)
    t1 = Tracker(RCFG, seq.intrinsics, device="cpu")
    feats_seq = []
    for k in range(len(imgs)):
        f = Tracker.features_at(t1.detect_batch(imgs[k:k + 1]), 0)
        feats_seq.append(f)
        t1.process_features(f, k)
    t2 = Tracker(RCFG, seq.intrinsics, device="cpu")
    t2.process_batch(imgs[:4], 0)
    t2.process_batch(imgs[4:], 4)
    fb = t2.detect_batch(imgs)
    for k, f in enumerate(feats_seq):
        g = Tracker.features_at(fb, k)
        a = f.keypoints.yx[f.keypoints.valid].numpy()
        b = g.keypoints.yx[g.keypoints.valid].numpy()
        assert abs(len(a) - len(b)) <= max(2, 0.05 * len(a))
        d = np.linalg.norm(a[:, None, :] - b[None, :, :], axis=-1)
        assert (d.min(axis=1) < 0.5).mean() >= 0.95
    total = sum(np.linalg.norm(a.t - b.t)
                for a, b in zip(t1.frames[1:], t2.frames[1:]))
    path = max(np.linalg.norm(t1.frames[-1].t), 1e-6)
    assert total / (len(t1.frames) * path) < 0.25


def test_process_stream_equals_process_batch():
    """The lag-1 stream (process_stream + finish) against synchronous
    chunk-by-chunk process_batch: the same engine calls on the same inputs
    in the same order, the same trajectory bit for bit."""
    seq, imgs = _frames(12)
    t1 = Tracker(RCFG, seq.intrinsics, device="cpu")
    for k in range(0, 12, 4):
        t1.process_batch(imgs[k:k + 4], k)
    t2 = Tracker(RCFG, seq.intrinsics, device="cpu")
    out = []
    for k in range(0, 12, 4):
        out.extend(t2.process_stream(imgs[k:k + 4], k))
    out.extend(t2.finish())
    assert sorted(r.frame_id for r in out) == list(range(12))
    assert len(t2.frames) == 12
    np.testing.assert_array_equal(t1.trajectory(), t2.trajectory())
    assert sum(f.is_keyframe for f in t1.frames) == sum(
        f.is_keyframe for f in t2.frames)


def test_tracker_raises_without_a_card_and_for_unported_options():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            Tracker(PCFG, INTR)
    # the window BA shards over a mesh's 'shard' axis: a mesh without one
    # is refused
    data_mesh = make_mesh(2, axis="data", devices=[torch.device("cpu")] * 2)
    with pytest.raises(ValueError, match="'shard' axis"):
        Tracker(PCFG, INTR, device="cpu", mesh=data_mesh)


# ---------------------------------------------------------------------
# the two packages on the same injected features
# ---------------------------------------------------------------------


@pytest.fixture()
def replayed(monkeypatch):
    """The port's RANSAC draws the reference's samples: the key chain of
    the reference tracker (PRNGKey(seed), split once per two-view init,
    tracker.py:215, 857), then split(sub, N) and one Gumbel top-k per key
    (ransac.py:39, 56), on the valid mask the port's matcher gives."""
    state = {"key": jax.random.PRNGKey(CFG.ransac.seed)}

    def sample(gen, valid, N, n):
        state["key"], sub = jax.random.split(state["key"])
        keys = jax.random.split(sub, N)
        v = jnp.asarray(valid.cpu().numpy())
        idx = jax.vmap(lambda k: jrs._gumbel_sample_indices(k, v, n))(keys)
        return torch.as_tensor(np.asarray(idx), device=valid.device)

    monkeypatch.setattr(trs, "sample_indices", sample)


def _wait_for_pending_ba(jt):
    """Let the reference's async window BA finish before the next frame
    (the port's CPU flush always finds it finished)."""
    if jt._pending_ba is not None:
        jax.block_until_ready(jt._pending_ba[-1])


PARITY_FRAMES = 24


@pytest.mark.parametrize("engine", [False, True])
def test_tracker_matches_jax_on_the_same_features(replayed, engine):
    """Bootstrap, two-view init and tracking of the same injected features
    in both packages: engine=False per frame through process_features;
    engine=True per frame for bootstrap and init, then through
    process_batch_features in batches of 8 (the engine batch)."""
    cfg = CFG.replace(ba=CFG.ba.replace(async_ba=True))
    pcfg = SlamConfig.from_json(cfg.to_json())
    scene = SyntheticScene(np.random.default_rng(11),
                           n_points=max(600, 14 * PARITY_FRAMES),
                           max_depth=0.45 * PARITY_FRAMES + 30.0)
    feats = [scene.features(k)[0] for k in range(PARITY_FRAMES)]
    jt = JTracker(cfg, INTR, engine=engine)
    pt = Tracker(pcfg, INTR, engine=engine, device="cpu")
    if engine:
        first = 4
        for k in range(first):
            _wait_for_pending_ba(jt)
            jt.process_features(jax_features(feats[k]), k)
            pt.process_features(port_features(feats[k]), k)
        B = 8
        for k in range(first, PARITY_FRAMES, B):
            fj = [jax_features(f) for f in feats[k:k + B]]
            fp = [port_features(f) for f in feats[k:k + B]]
            jb = jax.tree_util.tree_map(lambda *x: jnp.stack(x), *fj)
            pb = Features(Keypoints(*(torch.stack(x) for x in zip(
                *(f.keypoints for f in fp)))),
                torch.stack([f.descriptors for f in fp]))
            _wait_for_pending_ba(jt)
            jt.process_batch_features(jb, k, 0, len(fj))
            pt.process_batch_features(pb, k, 0, len(fp))
    else:
        for k, f in enumerate(feats):
            _wait_for_pending_ba(jt)
            jt.process_features(jax_features(f), k)
            pt.process_features(port_features(f), k)

    assert len(pt.frames) == len(jt.frames) == PARITY_FRAMES
    kf_p = [f.frame_id for f in pt.frames if f.is_keyframe]
    kf_j = [f.frame_id for f in jt.frames if f.is_keyframe]
    assert kf_p == kf_j and len(kf_j) >= 4
    assert [f.tracking_ok for f in pt.frames] == [
        f.tracking_ok for f in jt.frames]
    # with the same samples the two-view init still differs by float32
    # noise: the 8-point solves of both packages sit up to ~1e-2 from a
    # float64 solve (tests/test_torch_two_view.py), two correspondences
    # near the Sampson threshold flip and the median-depth scale moves by
    # ~1.5% (measured: landmarks 657 vs 649, Sim(3)-aligned centres 0.0136
    # RMS, scale 0.9855, rotations within 9.4e-4). Held: landmark counts
    # and uids within 2%, inliers per frame within 3% + 2, rotations
    # within 2e-3, the aligned centres within 0.05 RMS over the ~10-unit
    # path, the scale within 3%
    for a, b in ((pt.map.lm_valid.sum(), jt.map.lm_valid.sum()),
                 (pt.map._next_uid, jt.map._next_uid)):
        assert abs(int(a) - int(b)) <= 0.02 * int(b), (a, b)
    inl_p = np.array([f.num_inliers for f in pt.frames])
    inl_j = np.array([f.num_inliers for f in jt.frames])
    assert np.all(np.abs(inl_p - inl_j) <= 0.03 * inl_j + 2)
    Tp, Tj = pt.trajectory(), jt.trajectory()
    np.testing.assert_allclose(Tp[:, :, :3], Tj[:, :, :3], atol=2e-3)
    assert ate_rmse(Tp[:, :, 3], Tj[:, :, 3]) < 0.05
    s, _, _ = umeyama_alignment(Tp[:, :, 3], Tj[:, :, 3])
    assert abs(s - 1.0) < 0.03, s


def test_tracker_distributed_window_ba():
    """As tests/test_tracker.py's test_tracker_distributed_window_ba:
    Tracker(mesh=...) runs the window BA trajectory-sharded over a virtual
    4-shard CPU mesh (8 cameras in blocks of 2); its trajectory stays
    within the band of the one-device tracker and of the JAX package's
    Tracker(mesh=...) on conftest's virtual devices, on the same
    features."""
    from visualslam_tpu.parallel.mesh import make_mesh as jmake_mesh

    cfg = CFG.replace(ba=CFG.ba.replace(max_cameras=8, cg_iters=48))
    pcfg = SlamConfig.from_json(cfg.to_json())
    scene = SyntheticScene(np.random.default_rng(5))
    mesh = make_mesh(4, devices=[torch.device("cpu")] * 4)
    t_single = Tracker(pcfg, INTR, device="cpu")
    t_dist = Tracker(pcfg, INTR, device="cpu", mesh=mesh)
    t_jax = JTracker(cfg, INTR, mesh=jmake_mesh(4, axis="shard"))
    gt = []
    for k in range(12):
        f, (R, t) = scene.features(k)
        t_single.process_features(port_features(f), k)
        t_dist.process_features(port_features(f), k)
        t_jax.process_features(jax_features(f), k)
        gt.append(gt_pose(R, t))
    gt = np.stack(gt)
    a1, a2, aj = (_ate(t, gt) for t in (t_single, t_dist, t_jax))
    assert t_dist.last_ba_cost >= 0 and t_jax.last_ba_cost >= 0, \
        "distributed BA never ran"
    assert a2 < max(2.0 * a1, 0.05), (a1, a2)
    assert a2 < max(2.0 * aj, 0.05), (aj, a2)
    assert sum(f.is_keyframe for f in t_dist.frames) == sum(
        f.is_keyframe for f in t_jax.frames)

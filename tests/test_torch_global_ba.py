"""Global BA in both packages on one map: the port's tracker maps 30
injected-feature frames (window of 6 keyframes, so evicted keyframes are
archived), then both packages' run_global_ba optimize the full history of
that map (the JAX one reads the port's SlamMap, a copy of its own class).
An 80-keyframe map built through the map's API puts both on schur_mf."""

import numpy as np
import pytest
import torch

from test_torch_tracker import PCFG, port_features
from tracker_scene import CFG, INTR, SyntheticScene
from visualslam_tpu.slam.global_ba import run_global_ba as jrun
from visualslam_tpu_torch.slam.global_ba import build_global_problem
from visualslam_tpu_torch.slam.global_ba import run_global_ba as trun
from visualslam_tpu_torch.slam.tracker import Tracker

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(scope="module")
def tracked():
    scene = SyntheticScene(np.random.default_rng(2), n_points=800,
                           max_depth=50.0)
    tracker = Tracker(PCFG, INTR, device="cpu", loop_closure=False)
    for k in range(30):
        f, _ = scene.features(k, pix_noise=0.8)
        tracker.process_features(port_features(f), k)
    return tracker


def test_global_ba_matches_jax(tracked):
    smap = tracked.map
    assert len(smap.archive) >= 1, "no keyframe was archived"
    cfg = CFG.ba.replace(iters=8)
    ref = jrun(smap, cfg)
    got = trun(smap, PCFG.ba.replace(iters=8), device="cpu")
    np.testing.assert_array_equal(got.frame_ids, ref.frame_ids)
    assert (got.n_cameras, got.n_landmarks, got.n_observations) == (
        ref.n_cameras, ref.n_landmarks, ref.n_observations)
    assert got.n_cameras > PCFG.ba.max_cameras
    # the same problem: initial costs within 1e-5 relative; both solves
    # lower the cost, final costs within 2% and poses within 2e-3 / 2e-2
    # (float32 Schur GN in two libraries, atomics-free sums on the CPU)
    assert got.initial_cost == pytest.approx(ref.initial_cost, rel=1e-5)
    assert got.cost < got.initial_cost and ref.cost < ref.initial_cost
    assert got.cost == pytest.approx(ref.cost, rel=0.02)
    np.testing.assert_allclose(got.R, ref.R, atol=2e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=2e-2)


def test_global_ba_problem_and_unported_paths(tracked):
    p, fids = build_global_problem(tracked.map, device="cpu")
    assert p.R.device.type == "cpu" and len(fids) == p.R.shape[0]
    assert bool(p.obs_valid.all()) and p.cam_idx.dtype == torch.int32
    # a mesh of n shards pads the cameras to a multiple of n with invalid
    # identity cameras
    q, _ = build_global_problem(tracked.map, pad_cameras_to=4, device="cpu")
    K = len(fids)
    assert q.R.shape[0] % 4 == 0 and q.R.shape[0] - K < 4
    assert not bool(q.cam_valid[K:].any()) and bool(q.cam_valid[:K].all())
    torch.testing.assert_close(q.R[K:], torch.eye(3).expand(
        q.R.shape[0] - K, 3, 3))


def test_tracker_global_ba_adopts_the_poses(tracked):
    before = tracked.trajectory()
    res = tracked.global_ba()
    after = tracked.trajectory()
    assert np.isfinite(res.cost) and res.cost <= res.initial_cost
    # keyframes adopt the optimized poses; the trajectory moves by less
    # than 5% of its length (the monocular gauge's scale is free)
    kf = np.isin([f.frame_id for f in tracked.frames], res.frame_ids)
    for f, k in zip(tracked.frames, kf):
        if k:
            i = list(res.frame_ids).index(f.frame_id)
            np.testing.assert_allclose(f.R, res.R[i], atol=1e-6)
    path = np.linalg.norm(before[-1, :, 3] - before[0, :, 3])
    assert np.abs(after - before).max() < 0.05 * path


def _long_map(n_kf=80, window=6, seed=3):
    """A SlamMap over `n_kf` keyframes of a forward path (window `window`,
    so all but the last few are archived), built through the map's own
    API: ground-truth landmarks and poses with noise, observations of the
    visible landmarks with pixel noise. Returns (map, ground-truth R, t)."""
    from visualslam_tpu_torch.slam.map_state import SlamMap

    rng = np.random.default_rng(seed)
    Xw = rng.uniform([-10, -4, 4], [10, 4, 0.5 * n_kf + 20], (900, 3))
    m = SlamMap(window, 1200, 16)
    lm = m.allocate_landmarks(
        (Xw + rng.normal(0, 0.05, Xw.shape)).astype(np.float32))
    Rs, ts = [], []
    for k in range(n_kf):
        a = 0.003 * k
        R = np.array([[np.cos(a), 0, np.sin(a)], [0, 1, 0],
                      [-np.sin(a), 0, np.cos(a)]])
        t = -R @ np.array([0.02 * k, 0.0, 0.5 * k])
        Rs.append(R)
        ts.append(t)
        slot, _ = m.allocate_keyframe()
        Rn = R if k == 0 else R @ np.array(
            [[1, -1e-3, 0], [1e-3, 1, 0], [0, 0, 1]])
        tn = t + (0 if k == 0 else rng.normal(0, 0.02, 3))
        m.set_keyframe(slot, k, Rn.astype(np.float32),
                       tn.astype(np.float32), None, None, None)
        Xc = Xw @ R.T + t
        uv = Xc[:, :2] / Xc[:, 2:]
        vis = (Xc[:, 2] > 2) & (Xc[:, 2] < 25) & (np.abs(uv) < 0.6).all(1)
        uv = uv + rng.normal(0, 1e-3, uv.shape)
        m.add_observations(slot, lm[vis], uv[vis].astype(np.float32))
    return m, np.stack(Rs), np.stack(ts)


def test_global_ba_above_64_cameras_takes_schur_mf_and_matches_jax():
    """80 keyframes: both packages' run_global_ba hand the dense default
    over to schur_mf, and the port's solve matches the JAX package's on
    the same map."""
    m, _, _ = _long_map()
    assert len(m.archive) == 80 - 6
    cfg = CFG.ba.replace(iters=6)
    ref = jrun(m, cfg)
    got = trun(m, PCFG.ba.replace(iters=6), device="cpu")
    np.testing.assert_array_equal(got.frame_ids, ref.frame_ids)
    assert (got.n_cameras, got.n_landmarks, got.n_observations) == (
        ref.n_cameras, ref.n_landmarks, ref.n_observations)
    assert got.n_cameras == 80
    # initial costs within 1e-5 relative; the matrix-free CG solves of
    # two libraries in float32: final costs within 2%, poses within
    # 2e-3 / 2e-2 (as the dense case above)
    assert got.initial_cost == pytest.approx(ref.initial_cost, rel=1e-5)
    assert got.cost < 0.5 * got.initial_cost
    assert got.cost == pytest.approx(ref.cost, rel=0.02)
    np.testing.assert_allclose(got.R, ref.R, atol=2e-3)
    np.testing.assert_allclose(got.t, ref.t, atol=2e-2)


def test_tracker_global_ba_runs_above_64_keyframes(monkeypatch):
    """Tracker.global_ba over an 80-keyframe history runs schur_mf (it
    raised before the matrix-free solver was ported) and lowers the cost;
    every keyframe adopts its optimized pose."""
    from visualslam_tpu_torch.backend import ba as tba
    from visualslam_tpu_torch.slam.tracker import FrameResult

    m, _, _ = _long_map()
    tracker = Tracker(PCFG, INTR, device="cpu", loop_closure=False)
    tracker.map = m
    tracker.frames = [
        FrameResult(k, m.archive[k].R if k < len(m.archive)
                    else m.kf_R[m.kf_order[k - len(m.archive)]],
                    m.archive[k].t if k < len(m.archive)
                    else m.kf_t[m.kf_order[k - len(m.archive)]],
                    is_keyframe=True) for k in range(80)]
    solvers = []
    run_ba_jit = tba.run_ba_jit

    def spy(p, cfg):
        solvers.append(cfg.solver)
        return run_ba_jit(p, cfg)

    monkeypatch.setattr("visualslam_tpu_torch.slam.global_ba.run_ba_jit",
                        spy)
    res = tracker.global_ba()
    assert solvers == ["schur_mf"]
    assert res.n_cameras == 80 and res.cost < res.initial_cost
    for k, f in enumerate(tracker.frames):
        np.testing.assert_array_equal(f.R, res.R[k].astype(np.float32))


def test_global_ba_sharded_matches_single_and_jax(tracked):
    """As tests/test_global_ba.py's test_global_ba_sharded_matches_single:
    Tracker.global_ba(mesh=...) over a virtual 4-shard CPU mesh against the
    one-device solve and the JAX package's sharded solve of the same map.
    Monocular scale is a gauge freedom the solvers may pick differently:
    costs within 20%, Sim(3)-aligned camera centres within 0.03."""
    from visualslam_tpu.parallel.mesh import make_mesh as jmake_mesh
    from visualslam_tpu_torch.parallel.mesh import make_mesh
    from visualslam_tpu_torch.slam.evaluation import ate_rmse

    single = trun(tracked.map, PCFG.ba, device="cpu")
    ref = jrun(tracked.map, CFG.ba, mesh=jmake_mesh(4, axis="shard"))
    mesh = make_mesh(4, devices=[torch.device("cpu")] * 4)
    got = tracked.global_ba(mesh=mesh)
    assert got.n_cameras == single.n_cameras == ref.n_cameras
    assert got.cost < got.initial_cost
    assert got.initial_cost == pytest.approx(single.initial_cost, rel=1e-5)

    def centres(r):
        return np.stack([-R.T @ t for R, t in zip(r.R, r.t)])

    for other in (single, ref):
        np.testing.assert_allclose(got.cost, other.cost, rtol=0.2)
        assert ate_rmse(centres(got), centres(other)) < 0.03
    kf = {f.frame_id: f for f in tracked.frames}
    for i, fid in enumerate(got.frame_ids):
        np.testing.assert_allclose(kf[int(fid)].R, got.R[i], atol=1e-6)


def test_global_ba_above_64_cameras_sharded_matches_single():
    """The 80-keyframe map (schur_mf) over a virtual 4-shard CPU mesh:
    the matrix-free trajectory-sharded solve (scalar-Jacobi CG, one psum
    per matvec) against the one-device run_global_ba (block-Jacobi CG):
    the same initial cost, final costs within 1e-3 relative, camera
    centres within 0.01 (Sim(3)-aligned) over the ~40-unit path."""
    from visualslam_tpu_torch.parallel.mesh import make_mesh
    from visualslam_tpu_torch.slam.evaluation import ate_rmse

    m, _, _ = _long_map()
    one = trun(m, PCFG.ba, device="cpu")
    sh = trun(m, PCFG.ba, mesh=make_mesh(4, devices=[torch.device("cpu")]
                                         * 4), device="cpu")
    assert sh.n_cameras == one.n_cameras == 80
    assert sh.initial_cost == pytest.approx(one.initial_cost, rel=1e-5)
    assert sh.cost < 0.1 * sh.initial_cost
    assert sh.cost == pytest.approx(one.cost, rel=1e-3)

    def centres(r):
        return np.stack([-R.T @ t for R, t in zip(r.R, r.t)])

    assert ate_rmse(centres(sh), centres(one)) < 0.01

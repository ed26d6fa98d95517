"""Global BA in both packages on one map: the port's tracker maps 30
injected-feature frames (window of 6 keyframes, so evicted keyframes are
archived), then both packages' run_global_ba optimize the full history of
that map (the JAX one reads the port's SlamMap, a copy of its own class)."""

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
    with pytest.raises(NotImplementedError, match="A.10"):
        trun(tracked.map, PCFG.ba, mesh=object(), device="cpu")


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

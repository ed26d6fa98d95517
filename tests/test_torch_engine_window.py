"""The engine slice end to end in both packages: the same features (the
port's frontend on 32 synthetic frames, as two batches of 16) through one
function (visualslam_tpu_torch/slam/window.run_engine: ground-truth bootstrap
-> build_persist_from_host -> run_engine_batch per batch, the persist
chained), once with the port's functions and once with the JAX package's
(jitted). Two cases: the opt-in kernels' switches (extrema_impl="pallas",
blur_mode="pallas", match.impl="pallas", Pallas in interpret mode on the
JAX side) and FAST_CONFIG's own (the fused extrema, the matmul blur, the
dense matcher). A small loop database (16 entries, 64 sub keypoints,
exclude_recent 1) gives retrieval eligible entries in batch 1."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from test_torch_window import CASES, configs, jax_ops
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu_torch.frontend import SiftFrontend
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.slam.evaluation import ate_rmse
from visualslam_tpu_torch.slam.window import port_ops, run_engine, world_to_camera
from visualslam_tpu_torch.utils.config import SlamConfig

B, H, W, BATCHES = 16, 240, 376, 2
# integer fields of a loop row: candidate, usable matches, inliers, pairs
# with 3D on both sides, reciprocal inliers
LOOP_INT = [0, 2, 3, 17, 18]


def _centres(R, t):
    return -np.einsum("fji,fj->fi", R, t)


def engine_config(case):
    """The window tests' config of `case` with a small loop database and,
    for "pallas", the score-map extrema (the engine's third opt-in
    switch)."""
    jc = configs(case)
    return jc.replace(
        sift=jc.sift.replace(
            extrema_impl="pallas" if case == "pallas" else "fused"),
        loop=jc.loop.replace(db_capacity=16, sub_keypoints=64,
                             exclude_recent=1))


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    jc = engine_config(request.param)
    cfg = SlamConfig.from_json(jc.to_json())
    seq = SyntheticSequence(num_frames=B * BATCHES, h=H, w=W, n_dots=1500,
                            step=0.4)
    frames = np.stack([seq.frame(k) for k in range(len(seq))])
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    fe = SiftFrontend(cfg)
    feats = [fe(torch.from_numpy(frames[b * B:(b + 1) * B]))
             for b in range(BATCHES)]
    R_gt, t_gt = world_to_camera(seq.gt_poses)
    port = run_engine(port_ops("cpu"), feats, R_gt, t_gt,
                      torch.tensor(seq.intrinsics), cfg)
    jfeats = [JFeatures(JKeypoints(*(jnp.asarray(x.numpy())
                                     for x in f.keypoints)),
                        jnp.asarray(f.descriptors.numpy())) for f in feats]
    ref = run_engine(jax_ops(), jfeats, R_gt, t_gt,
                     jnp.asarray(seq.intrinsics), jc)
    return port, ref, R_gt, t_gt


def test_engine_promotes_like_jax(runs):
    port, ref, _, _ = runs
    np.testing.assert_array_equal(port.promoted, ref.promoted)
    assert [len(p) for p in port.proms] == [len(p) for p in ref.proms]
    assert all(len(p) >= 1 for p in port.proms)
    assert port.db_n == ref.db_n == np.cumsum(
        [len(p) for p in port.proms]).tolist()
    for a_b, r_b in zip(port.proms, ref.proms):
        for a, r in zip(a_b, r_b):
            assert a.frame == r.frame and a.n2d == r.n2d
            np.testing.assert_array_equal(a.tri_good, r.tri_good)


def test_engine_tracks_like_jax(runs):
    port, ref, R_gt, t_gt = runs
    active = np.arange(B * BATCHES) >= 5
    assert (port.inliers[active] >= port.ok_min).all()
    # a PnP inlier flips on a residual at the Huber threshold: the counts
    # agree within one
    np.testing.assert_array_less(np.abs(port.inliers - ref.inliers), 1.5)
    # float32 LM, window BA and triangulation in two libraries, chained
    # over 27 frames and 6 promotions: rotations within 2e-4, positions
    # within 5e-3 of the 0.4-unit step (measured 3.5e-5 and 9.2e-4)
    np.testing.assert_allclose(port.R, ref.R, rtol=0, atol=2e-4)
    np.testing.assert_allclose(port.t, ref.t, rtol=0, atol=5e-3)
    for a, r in zip(port.tails, ref.tails):
        assert a.ba_cost == pytest.approx(r.ba_cost, rel=1e-3)
        assert np.isfinite(a.ba_cost) and a.ba_cost >= 0
    ate = ate_rmse(_centres(port.R, port.t)[active],
                   _centres(R_gt, t_gt)[active])
    ate_ref = ate_rmse(_centres(ref.R, ref.t)[active],
                       _centres(R_gt, t_gt)[active])
    assert ate == pytest.approx(ate_ref, abs=2e-3) and ate < 0.5


def test_engine_loop_rows_like_jax(runs):
    """Retrieval picks the same candidates (ties among the -2.0 of
    ineligible entries go to the lower index), and where both sides have
    >= 10 usable matches the verification counts agree."""
    port, ref, _, _ = runs
    checked = eligible = 0
    for a_b, r_b in zip(port.proms, ref.proms):
        for a, r in zip(a_b, r_b):
            np.testing.assert_array_equal(a.loop[:, 0], r.loop[:, 0])
            np.testing.assert_allclose(a.loop[:, 1], r.loop[:, 1], atol=1e-5)
            eligible += int((r.loop[:, 1] > -2.0).sum())
            both = (a.loop[:, 2] >= 10) & (r.loop[:, 2] >= 10)
            np.testing.assert_array_equal(a.loop[both][:, LOOP_INT],
                                          r.loop[both][:, LOOP_INT])
            checked += int(both.sum())
    assert eligible > 0 and checked > 0


def test_longer_sequence_keeps_its_first_frames():
    """chip_smoke.py renders 48 frames where the earlier slices rendered
    24: the dolly path's pose k and frame k do not depend on the length."""
    a = SyntheticSequence(num_frames=24, h=48, w=64, n_dots=300, step=0.4)
    b = SyntheticSequence(num_frames=48, h=48, w=64, n_dots=300, step=0.4)
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses[:24])
    for k in (0, 11, 23):
        np.testing.assert_array_equal(a.frame(k), b.frame(k))

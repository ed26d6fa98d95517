"""The tracking slice end to end in both packages: the same features (the
port's frontend on 16 synthetic frames) through one function
(visualslam_tpu_torch/slam/window.run_window: ground-truth bootstrap ->
track_batch -> keyframe_step -> window BA), once with the port's functions
and once with the JAX package's. Two cases: the switches that put the
opt-in kernels on the path (blur_mode="pallas", match.impl="pallas",
Pallas in interpret mode on the JAX side) and FAST_CONFIG's own (the
matmul blur, the dense matcher)."""

from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.backend import ba as jba
from visualslam_tpu.geometry import se3 as jse3
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.slam import engine as jengine
from visualslam_tpu.slam import track_step as jts
from visualslam_tpu.slam.map_state import SlamMap as JSlamMap
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.frontend import SiftFrontend
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.slam.window import (
    port_ops,
    run_window,
    world_to_camera,
)
from visualslam_tpu_torch.utils.config import SlamConfig

B, H, W, K = 16, 240, 376, 256
CASES = ("pallas", "fast")


def configs(case):
    """The JAX config of a case at the tests' sizes: "pallas" pins
    blur_mode="pallas" and match.impl="pallas", "fast" keeps FAST_CONFIG's
    own "matmul" and "xla". Both pin the fused extrema and the bf16 patch
    kernels, which the JAX package's "auto" would not pick on the CPU."""
    fast = case == "fast"
    return jcfg.FAST_CONFIG.replace(
        pyramid=jcfg.FAST_CONFIG.pyramid.replace(
            num_octaves=2, blur_mode="matmul" if fast else "pallas"),
        sift=jcfg.FAST_CONFIG.sift.replace(max_keypoints=K,
                                           max_keypoints_per_octave=K // 2,
                                           extrema_impl="fused",
                                           patch_impl="pallas",
                                           hist_compute="bf16"),
        match=jcfg.FAST_CONFIG.match.replace(impl="xla" if fast else "pallas",
                                             tile=128, max_matches=K // 2),
        local_map_size=K,
        ba=jcfg.FAST_CONFIG.ba.replace(max_landmarks=1024,
                                       max_observations=3072))


def _jax_dyn(frame_base, start, stop, Kl):
    return jengine.EngineDyn(
        frame_base=jnp.int32(frame_base), start=jnp.int32(start),
        stop=jnp.int32(stop), kill=jnp.zeros(Kl, bool),
        kill_gen=jnp.zeros(Kl, jnp.int32))


def jax_ops():
    """The JAX package's functions for run_window and run_engine (jitted as
    the tracker jits them)."""
    return SimpleNamespace(
        run_engine_batch=jax.jit(jengine.run_engine_batch,
                                 static_argnums=(4, 5, 6)),
        build_persist_from_host=jengine.build_persist_from_host,
        engine_dyn=_jax_dyn, decode_packed=jengine.decode_packed,
        track_batch=jax.jit(jts.track_batch, static_argnums=(5, 6)),
        keyframe_step=jax.jit(jts.keyframe_step, static_argnums=(4, 5)),
        lite_at=jts.lite_at, index_features=jts.index_features,
        build_local_map=jts.build_local_map,
        pack_keyframe_products=jts.pack_keyframe_products,
        unpack_keyframe_products=jts.unpack_keyframe_products,
        TrackAssoc=jts.TrackAssoc, TrackState=jts.TrackState,
        KeyframeRef=jts.KeyframeRef, TrackLite=jts.TrackLite,
        BAProblem=jba.BAProblem, run_ba=jax.jit(jba.run_ba, static_argnums=1),
        SlamMap=JSlamMap, se3=jse3, asarray=jnp.asarray, tonumpy=np.asarray)


@pytest.fixture(scope="module", params=CASES)
def runs(request):
    jc = configs(request.param)
    cfg = SlamConfig.from_json(jc.to_json())
    seq = SyntheticSequence(num_frames=B, h=H, w=W, n_dots=1500, step=0.4)
    frames = np.stack([seq.frame(k) for k in range(B)])
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    feats = SiftFrontend(cfg)(torch.from_numpy(frames))
    R_gt, t_gt = world_to_camera(seq.gt_poses)
    port = run_window(port_ops("cpu"), feats, R_gt, t_gt,
                      torch.tensor(seq.intrinsics), cfg)
    jfeats = JFeatures(JKeypoints(*(jnp.asarray(x.numpy())
                                    for x in feats.keypoints)),
                       jnp.asarray(feats.descriptors.numpy()))
    ref = run_window(jax_ops(), jfeats, R_gt, t_gt,
                     jnp.asarray(seq.intrinsics), jc)
    return port, ref, R_gt, t_gt


def test_window_tracks_like_jax(runs):
    port, ref, R_gt, _ = runs
    np.testing.assert_array_equal(port.ok, ref.ok)
    assert port.ok[5:10].all() and not port.ok[:5].any()
    np.testing.assert_array_equal(port.inliers, ref.inliers)
    assert port.new_landmarks == ref.new_landmarks
    assert port.max_depth == pytest.approx(ref.max_depth, rel=1e-3)
    # same matches and inliers; float32 LM in two libraries, chained over
    # 11 frames: rotations within 1e-4, positions within 2e-3 of the
    # 0.4-unit step
    np.testing.assert_allclose(port.R, ref.R, atol=1e-4)
    np.testing.assert_allclose(port.t, ref.t, atol=2e-3)
    c = (np.trace(port.R[5:10] @ R_gt[5:10].transpose(0, 2, 1), axis1=1,
                  axis2=2) - 1) / 2
    assert np.degrees(np.arccos(np.clip(c, -1, 1))).max() < 0.5


def test_window_ba_like_jax(runs):
    port, ref, _, _ = runs
    assert port.ba_sizes == ref.ba_sizes
    assert port.ba_sizes[0] == 3 and port.ba_sizes[1] > 50
    init, final = port.ba_cost
    assert np.isfinite(final) and final <= init
    assert init == pytest.approx(ref.ba_cost[0], rel=1e-3)
    assert final == pytest.approx(ref.ba_cost[1], rel=1e-2)
    np.testing.assert_allclose(port.kf_R, ref.kf_R, atol=1e-4)
    np.testing.assert_allclose(port.kf_t, ref.kf_t, atol=2e-3)

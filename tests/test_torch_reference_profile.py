"""The port's reference profile (DEFAULT_CONFIG: 2x linear upsample, 4
octaves, float32 patch histograms) against the JAX package, at small
sizes: the upsample, the blur modes, the pyramid, the XLA patch path and
the max descriptor norm, the frontend as a keypoint set, and the Tracker
on rendered frames as a band."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.frontend import detect_and_describe as jax_detect
from visualslam_tpu.models import pyramid as jpyr
from visualslam_tpu.ops import blur as jblur
from visualslam_tpu.ops.resize import upsample2x_linear as jax_upsample
from visualslam_tpu.slam.tracker import Tracker as JTracker
from visualslam_tpu.utils import config as jcfg
from tracker_scene import CFG
from visualslam_tpu_torch.frontend import SiftFrontend, detect_and_describe
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models import pyramid as tpyr
from visualslam_tpu_torch.ops import blur as tblur
from visualslam_tpu_torch.ops.resize import upsample2x_linear
from visualslam_tpu_torch.slam.evaluation import ate_rmse
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.utils.config import SlamConfig

ULP1 = float(np.spacing(np.float32(1.0)))     # 2^-23, one ulp of 1.0
# separable float32 convolutions summed in another order (and with other
# fused multiply-adds) than XLA's: a few ulps of the [0, 1] values
CONV_ATOL = 4 * ULP1
ATOL = 1e-5             # the pyramid's stacks (tests/test_torch_pyramid.py)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, h=96, w=128, dots=600):
    seq = SyntheticSequence(num_frames=n, h=h, w=w, n_dots=dots)
    f = np.stack([seq.frame(k) for k in range(n)])
    return seq, np.clip(f * 255.0, 0, 255).astype(np.uint8)


def test_upsample_matches_jax_resize(rng):
    """2x linear upsample against jax.image.resize: within 2 ulp of 1.0 on
    [0, 1] data (two float32 products against the JAX package's one
    einsum)."""
    img = rng.random((3, 47, 90), dtype=np.float32)
    got = upsample2x_linear(torch.from_numpy(img)).numpy()
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(jax.vmap(jax_upsample))(jnp.asarray(img)))
    assert got.shape == want.shape == (3, 94, 180)
    assert np.abs(got - want).max() <= 2 * ULP1


SIGMAS = tpyr.level_sigmas(SlamConfig().pyramid)
BLURS = {
    "conv": (lambda t: tblur.blur_stack(t, SIGMAS),
             lambda j: jblur.blur_stack(j, SIGMAS), CONV_ATOL),
    "incremental": (lambda t: tblur.incremental_blur_stack(t, SIGMAS),
                    lambda j: jblur.incremental_blur_stack(j, SIGMAS),
                    CONV_ATOL),
    "gaussian_1": (lambda t: tblur.gaussian_blur(t, 1.0),
                   lambda j: jblur.gaussian_blur(j, 1.0), CONV_ATOL),
    "gaussian_2": (lambda t: tblur.gaussian_blur(t, 2.0),
                   lambda j: jblur.gaussian_blur(j, 2.0), CONV_ATOL),
    # sums of 3 + 3 values in the window's order: equal bits
    "box_3": (lambda t: tblur.box_filter(t, 3),
              lambda j: jblur.box_filter(j, 3), 0.0),
    # XLA adds 5 values pairwise, the port in order: an ulp of the sum
    # (values up to 25)
    "box_5": (lambda t: tblur.box_filter(t, 5),
              lambda j: jblur.box_filter(j, 5), 4 * 25 * ULP1),
}


@pytest.mark.parametrize("name", list(BLURS))
def test_blur_matches_jax(rng, name):
    port, ref, atol = BLURS[name]
    img = rng.random((2, 50, 70), dtype=np.float32)
    got = port(torch.from_numpy(img)).numpy()
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(jax.vmap(ref))(jnp.asarray(img)))
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= atol


@pytest.mark.parametrize("blur_mode", ["matmul", "conv", "incremental"])
def test_build_pyramid_default_matches_jax(rng, blur_mode):
    """DEFAULT_CONFIG.pyramid (2x upsample) at 3 octaves on 96x128 frames."""
    img = rng.random((2, 96, 128), dtype=np.float32)
    jp = jcfg.DEFAULT_CONFIG.pyramid.replace(num_octaves=3,
                                             blur_mode=blur_mode)
    ss = tpyr.build_pyramid(torch.from_numpy(img),
                            SlamConfig.from_json(
                                jcfg.DEFAULT_CONFIG.replace(
                                    pyramid=jp).to_json()).pyramid)
    assert tuple(ss.gauss[0].shape) == (2, 6, 192, 256)
    with jax.default_matmul_precision("float32"):
        fn = jax.jit(jax.vmap(lambda i: jpyr.build_pyramid(i, jp)))
        ref = fn(jnp.asarray(img))
    for o in range(3):
        for field in ("gauss", "dog", "grad_mag"):
            got = getattr(ss, field)[o].numpy()
            want = np.asarray(getattr(ref, field)[o])
            assert got.shape == want.shape
            np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                       err_msg=f"{field} octave {o}")


def test_auto_num_octaves_equals_jax():
    for h, w in ((376, 1241), (96, 128), (31, 2000), (4000, 3000)):
        assert tpyr.auto_num_octaves(h, w) == jpyr.auto_num_octaves(h, w)


def _small(cfg, pin: str, hist: str = "f32", **sift):
    """DEFAULT at 3 octaves with capacities 128 per octave / 256 in all,
    the detection and patch paths pinned on both sides: "pallas" (the
    fused extrema, the patch kernels; the JAX package's in interpret mode)
    or "xla" (both packages' plain formulations)."""
    return cfg.replace(
        pyramid=cfg.pyramid.replace(num_octaves=3),
        sift=cfg.sift.replace(
            max_keypoints=256, max_keypoints_per_octave=128,
            extrema_impl="fused" if pin == "pallas" else "xla",
            patch_impl=pin, hist_compute=hist, **sift))


def assert_feature_sets_agree(jf, pf, min_kps=30):
    """Per frame: counts within 5% (+2), >= 95% of the JAX package's
    keypoints within 0.5 px of one of the port's, median descriptor cosine
    of coincident keypoints > 0.999 (extrema near the threshold flip with
    an ulp of the blur; tests/test_torch_frontend.py's criteria)."""
    for b in range(jf.descriptors.shape[0]):
        vx = np.asarray(jf.keypoints.valid[b])
        vp = pf.keypoints.valid[b].numpy()
        nx = int(vx.sum())
        assert nx > min_kps
        assert abs(int(vp.sum()) - nx) <= max(2, 0.05 * nx)
        a = np.asarray(jf.keypoints.yx[b])[vx]
        p = pf.keypoints.yx[b].numpy()[vp]
        d = np.linalg.norm(a[:, None] - p[None, :], axis=-1)
        assert (d.min(axis=1) < 0.5).mean() > 0.95
        j = d.argmin(axis=1)
        close = d.min(axis=1) < 1e-3
        dx = np.asarray(jf.descriptors[b])[vx][close].astype(np.float32)
        dp = pf.descriptors[b].numpy()[vp][j[close]]
        cos = (dx * dp).sum(1) / np.maximum(
            np.linalg.norm(dx, axis=1) * np.linalg.norm(dp, axis=1), 1e-9)
        assert np.median(cos) > 0.999


@pytest.mark.parametrize("pin,norm,hist", [
    ("pallas", "l2", "f32"), ("xla", "l2", "f32"), ("xla", "max", "f32"),
    ("xla", "l2", "bf16")])
def test_default_frontend_matches_jax(pin, norm, hist):
    """The DEFAULT (reference) profile's SIFT frontend as a keypoint set;
    the "xla" cases run patch_impl="xla" on both sides, one with the
    reference's max descriptor norm, one with bfloat16 histogram compute
    (float32 patches, as the XLA formulation samples)."""
    _, frames = _frames(2)
    cfg = _small(jcfg.DEFAULT_CONFIG, pin, hist, descriptor_norm=norm)
    with jax.default_matmul_precision("float32"):
        fn = jax.jit(jax.vmap(lambda im: jax_detect(im, cfg)))
        jf = jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(frames)))
    port_cfg = SlamConfig.from_json(cfg.to_json())
    pf = SiftFrontend(port_cfg)(torch.from_numpy(frames))
    assert tuple(pf.descriptors.shape) == (2, 256, 128)
    # keypoints in input pixels: the upsampled octave 0 is halved
    yx = pf.keypoints.yx[pf.keypoints.valid]
    assert yx.max() < 128 and yx.min() >= 0
    if norm == "max":
        peak = pf.descriptors.amax(-1)[pf.keypoints.valid]
        np.testing.assert_allclose(peak.numpy(), 1.0, atol=1e-6)
    assert_feature_sets_agree(jf, pf)
    assert torch.equal(detect_and_describe(torch.from_numpy(frames),
                                           port_cfg).descriptors,
                       pf.descriptors)


def test_reference_tracker_band_against_jax():
    """Tracker(DEFAULT-small) on 12 rendered 96x128 frames through both
    packages' frontends (the "xla" pins, which the JAX package runs fast on
    the CPU), batches of 4, as a band: both track every frame, keyframe
    counts within 1, mean inliers within 15% and Sim(3)-aligned ATE of each
    below 0.3 (one frame step is 0.4) and within 0.1 of the other. The
    frontends' near-threshold extrema differ (an ulp of the blur), so the
    trajectories are not equal."""
    seq, frames = _frames(12)
    cfg = _small(CFG, "xla").replace(
        ransac=CFG.ransac.replace(inlier_threshold=4e-3),
        keyframe_min_inliers=20)
    gt = seq.gt_poses[:, :, 3]
    jt = JTracker(cfg, seq.intrinsics)
    pt = Tracker(SlamConfig.from_json(cfg.to_json()), seq.intrinsics,
                 device="cpu")
    for k in range(0, 12, 4):
        jt.process_batch(frames[k:k + 4], k)
        pt.process_batch(frames[k:k + 4], k)
    stats = []
    for t in (jt, pt):
        assert len(t.frames) == 12
        assert all(f.tracking_ok for f in t.frames)
        inl = [f.num_inliers for f in t.frames if f.num_inliers > 0]
        stats.append((sum(f.is_keyframe for f in t.frames), np.mean(inl),
                      ate_rmse(t.trajectory()[:, :, 3], gt)))
    (kj, ij, aj), (kp, ip, ap) = stats
    assert abs(kj - kp) <= 1, stats
    assert abs(ip - ij) <= 0.15 * ij, stats
    assert max(aj, ap) < 0.3 and abs(aj - ap) < 0.1, stats

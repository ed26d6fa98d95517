"""The port's ORB frontend and its parts against the JAX package, at small
sizes: FAST, the Harris response and the window peaks for equality, the
BRIEF pattern bit for bit, the antialiased level resize, the frontend as a
keypoint set with a Hamming bound, the Hamming matcher for equality, and
the ORB tracker end to end (tests/test_tracker.py's contract) and as a
band against the JAX Tracker."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracker_scene import CFG
from visualslam_tpu.frontend import detect_and_describe as jax_detect
from visualslam_tpu.models import orb as jorb
from visualslam_tpu.models.matching import match_features as jax_match
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.ops.distance import hamming_distance_matrix as jax_hamming
from visualslam_tpu.ops.fast import fast_score_map as jax_fast
from visualslam_tpu.ops.harris import harris_response as jax_harris
from visualslam_tpu.ops.nms import window_peaks as jax_peaks
from visualslam_tpu.slam.tracker import Tracker as JTracker
from visualslam_tpu_torch.frontend import OrbFrontend
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models import orb as torb
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.distance import (
    hamming_distance_matrix,
    unpack_bits,
)
from visualslam_tpu_torch.ops.fast import fast_score_map
from visualslam_tpu_torch.ops.harris import harris_response
from visualslam_tpu_torch.ops.nms import window_peaks
from visualslam_tpu_torch.ops.resize import resize_linear, weight_matrix
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.utils.config import SlamConfig

ULP1 = float(np.spacing(np.float32(1.0)))


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _frames(n, h=120, w=160, dots=500):
    seq = SyntheticSequence(num_frames=n, h=h, w=w, n_dots=dots)
    return seq, np.stack([seq.frame(k) for k in range(n)]).astype(np.float32)


@pytest.mark.parametrize("threshold,arc", [(0.08, 9), (0.05, 12)])
def test_fast_score_map_equals_jax(threshold, arc):
    _, img = _frames(2)
    c, s = fast_score_map(torch.from_numpy(img), threshold, arc)
    jc, js = jax.jit(jax.vmap(lambda i: jax_fast(i, threshold, arc)))(
        jnp.asarray(img))
    assert int(c.sum()) > 100
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


def test_harris_response_equals_jax(rng):
    """Same gradients in: the same bits out (the two fused multiply-adds
    rounded once each, as XLA fuses them)."""
    dx = (0.1 * rng.standard_normal((2, 40, 60))).astype(np.float32)
    dy = (0.1 * rng.standard_normal((2, 40, 60))).astype(np.float32)
    got = harris_response(torch.from_numpy(dx), torch.from_numpy(dy))
    want = jax.jit(jax.vmap(lambda a, b: jax_harris(a, b, 3, 0.04)))(
        jnp.asarray(dx), jnp.asarray(dy))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("window,threshold", [(3, float("-inf")), (5, 0.0)])
def test_window_peaks_equal_jax(rng, window, threshold):
    """Quantised scores (plateaus survive) with -inf holes, as ORB feeds
    them."""
    x = np.round(rng.random((2, 40, 50)) * 4).astype(np.float32)
    x = np.where(rng.random(x.shape) > 0.4, x, -np.inf).astype(np.float32)
    got = window_peaks(torch.from_numpy(x), window, threshold)
    want = jax.vmap(lambda a: jax_peaks(a, window, threshold))(
        jnp.asarray(x))
    assert int(got.sum()) > 50
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_brief_pattern_and_centroid_weights_equal_jax():
    for cfg in (SlamConfig().orb, SlamConfig().orb.replace(brief_seed=7,
                                                           brief_pairs=64)):
        jc = jorb.OrbConfig(**{k: getattr(cfg, k) for k in
                               cfg.__dataclass_fields__})
        got, want = torb.brief_pattern(cfg), jorb.brief_pattern(jc)
        assert got.dtype == want.dtype == np.float32
        np.testing.assert_array_equal(got.view(np.uint32),
                                      want.view(np.uint32))
    for a, b in zip(torb._centroid_weights(31), jorb._centroid_weights(31)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("hw", [(100, 133), (69, 93), (313, 1040)])
def test_level_resize_matches_jax(rng, hw):
    """The antialiased 1/1.2^l level resize against jax.image.resize on
    [0, 1] data: within 1.5 ulp of 1.0 of the float64 product of the same
    weights, and within 4 ulp of 1.0 of the JAX package's result (whose
    own weights and einsum sit up to ~2.7 ulp from that product)."""
    H, W = (120, 160) if hw[0] < 120 else (376, 1248)
    img = rng.random((2, H, W), dtype=np.float32)
    h, w = hw
    got = resize_linear(torch.from_numpy(img), h, w).numpy()
    with jax.default_matmul_precision("float32"):
        want = np.asarray(jax.jit(jax.vmap(
            lambda i: jax.image.resize(i, (h, w), "linear")))(
                jnp.asarray(img)))
    exact = (weight_matrix(H, h).astype(np.float64).T
             @ img.astype(np.float64) @ weight_matrix(W, w).astype(np.float64))
    assert got.shape == want.shape == (2, h, w)
    assert np.abs(got - exact).max() <= 1.5 * ULP1
    assert np.abs(got - want).max() <= 4 * ULP1


ORB_CFG = SlamConfig().replace(
    frontend="orb", orb=SlamConfig().orb.replace(num_levels=4,
                                                 max_keypoints=512))


@pytest.fixture(scope="module")
def orb_feats():
    _, img = _frames(2)
    cfg = ORB_CFG
    from visualslam_tpu.utils.config import SlamConfig as JCfg

    jc = JCfg.from_json(cfg.to_json())
    with jax.default_matmul_precision("float32"):
        jf = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(
            lambda i: jax_detect(i, jc)))(jnp.asarray(img)))
    return jf, OrbFrontend(cfg)(torch.from_numpy(img))


def _bits(d: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(d).view(np.uint8), axis=-1)


def test_orb_frontend_matches_jax(orb_feats):
    """Keypoints as a set, matched by (position, level): counts within 5%,
    >= 95% of the JAX package's within 0.5 px of the port's at the same
    level; descriptors of coincident keypoints compared by Hamming distance
    (a BRIEF bit flips on equal or ulp-apart samples): median 0 and at
    most 8 of 256 bits on >= 98% of them."""
    jf, pf = orb_feats
    assert pf.descriptors.dtype == torch.uint32
    assert tuple(pf.descriptors.shape) == (2, 512, 8)
    for b in range(2):
        vx = jf.keypoints.valid[b]
        vp = pf.keypoints.valid[b].numpy()
        assert vx.sum() > 200
        assert abs(int(vp.sum()) - int(vx.sum())) <= 0.05 * vx.sum()
        key = lambda yx, lvl: np.concatenate(   # noqa: E731
            [yx, 1e4 * lvl[:, None].astype(np.float32)], 1)
        a = key(jf.keypoints.yx[b][vx], jf.keypoints.level[b][vx])
        p = key(pf.keypoints.yx[b].numpy()[vp],
                pf.keypoints.level[b].numpy()[vp])
        d = np.linalg.norm(a[:, None] - p[None], axis=-1)
        assert (d.min(axis=1) < 0.5).mean() >= 0.95
        close = d.min(axis=1) < 1e-3
        j = d.argmin(axis=1)[close]
        ham = (_bits(jf.descriptors[b][vx][close])
               != _bits(pf.descriptors[b].numpy()[vp][j])).sum(1)
        assert np.median(ham) == 0 and (ham <= 8).mean() >= 0.98


def test_hamming_distance_matrix_equals_jax(rng):
    a = rng.integers(0, 2 ** 32, (3, 40, 8), dtype=np.uint64).astype(np.uint32)
    b = rng.integers(0, 2 ** 32, (3, 50, 8), dtype=np.uint64).astype(np.uint32)
    got = hamming_distance_matrix(torch.from_numpy(a), torch.from_numpy(b))
    bits = unpack_bits(torch.from_numpy(a[0]))
    np.testing.assert_array_equal(
        bits.numpy().astype(np.uint8),
        np.unpackbits(a[0].view(np.uint8), axis=1, bitorder="little"))
    for i in range(3):
        want = jax_hamming(jnp.asarray(a[i]), jnp.asarray(b[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want))


def test_match_features_hamming_equals_jax(orb_feats):
    """The same ORB descriptors into both matchers (metric="hamming", the
    un-squared ratio): the same matches."""
    jf, _ = orb_feats
    cfg = ORB_CFG.match.replace(metric="hamming")

    def frame(i, T, K, lib):
        return T(K(*(lib(np.array(x[i])) for x in jf.keypoints)),
                 lib(np.array(jf.descriptors[i])))

    fa = frame(0, Features, Keypoints, torch.from_numpy)
    fb = frame(1, Features, Keypoints, torch.from_numpy)
    got = match_features(fa, fb, cfg)
    from visualslam_tpu.utils.config import MatchConfig

    want = jax_match(frame(0, JFeatures, JKeypoints, jnp.asarray),
                     frame(1, JFeatures, JKeypoints, jnp.asarray),
                     MatchConfig(**{k: getattr(cfg, k) for k in
                                    cfg.__dataclass_fields__}))
    assert int(want.count()) > 50
    for field in ("idx_a", "idx_b", "valid", "distance"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))


TRACK_CFG = CFG.replace(
    frontend="orb", orb=CFG.orb.replace(num_levels=4, max_keypoints=512),
    keyframe_min_inliers=20,
    ransac=CFG.ransac.replace(inlier_threshold=4e-3))


def test_orb_tracker_end_to_end():
    """tests/test_tracker.py::test_orb_tracker_end_to_end on the port:
    bit-packed descriptors flow through the local map and the Hamming
    matcher."""
    seq, imgs = _frames(10)
    t = Tracker(SlamConfig.from_json(TRACK_CFG.to_json()), seq.intrinsics,
                device="cpu")
    assert t.cfg.match.metric == "hamming"
    res = t.process_batch(imgs, 0)
    assert len(res) == 10
    assert t.map.lm_valid.sum() > 20, "ORB two-view init failed"
    ok = [r.tracking_ok for r in res]
    assert sum(ok) >= 6, f"ORB tracking mostly lost: {ok}"


def test_orb_tracker_band_against_jax():
    """Both packages' ORB trackers on the same 10 frames (their own
    frontends): the same tracking-ok flags, landmark counts within 2%,
    per-frame inliers within 10% + 3."""
    seq, imgs = _frames(10)
    jt = JTracker(TRACK_CFG, seq.intrinsics)
    pt = Tracker(SlamConfig.from_json(TRACK_CFG.to_json()), seq.intrinsics,
                 device="cpu")
    jt.process_batch(imgs, 0)
    pt.process_batch(imgs, 0)
    assert [f.tracking_ok for f in pt.frames] == [
        f.tracking_ok for f in jt.frames]
    lj, lp = int(jt.map.lm_valid.sum()), int(pt.map.lm_valid.sum())
    assert abs(lp - lj) <= 0.02 * lj
    inl_j = np.array([f.num_inliers for f in jt.frames])
    inl_p = np.array([f.num_inliers for f in pt.frames])
    assert np.all(np.abs(inl_p - inl_j) <= 0.1 * inl_j + 3)

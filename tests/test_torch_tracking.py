"""The port's tracking (PnP, track_step, the numpy map) against the JAX
package: a synthetic scene of known points seen from known poses, the same
numpy state handed to both packages (utils/convert.from_numpy on the port
side). Each test that matches runs twice: with the matcher on its
streaming 2-NN path (impl="pallas", Pallas in interpret mode on the JAX
side) and on FAST_CONFIG's own dense matcher (impl="xla")."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.backend.pnp import refine_pose as jax_refine_pose
from visualslam_tpu.geometry import se3 as jse3
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.slam import map_state as jms
from visualslam_tpu.slam import track_step as jts
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.backend.pnp import refine_pose
from visualslam_tpu_torch.models.types import Features
from visualslam_tpu_torch.slam import map_state as tms
from visualslam_tpu_torch.slam import track_step as tts
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.convert import from_numpy

K = 256                     # keypoint and local-map capacity (2 tiles)
N = 180                     # scene points
INTR = np.array([225.6, 225.6, 188.0, 120.0], np.float32)   # 376 x 240
OK_MIN = 10
# float32 LM in two libraries over the same matches: poses agree to ~1e-6
# rad and ~1e-5 of the scene scale
POSE_TOL = 2e-5
# the dense matcher ranks matches by float32 distances that the two
# libraries' products round differently: neighbours closer than this
# relative gap may swap rank (two did, at ranks 75 and 76 of one frame,
# 5.7e-6 apart; the next closest neighbours are 2.3e-5 apart)
RANK_GAP = 1e-5
# the same matches in another rank order: the LM sums its residuals in
# another order, and over three tracked frames the poses part by up to
# 3.19e-5 (measured)
DENSE_POSE_TOL = 1e-4


def configs(impl):
    """(JAX config, port config) at the tests' sizes with the matcher on
    `impl`: "pallas" (the streaming 2-NN) or "xla" (FAST_CONFIG's own)."""
    j = jcfg.FAST_CONFIG.replace(
        match=jcfg.FAST_CONFIG.match.replace(impl=impl, tile=128,
                                             max_matches=128),
        local_map_size=K)
    return j, SlamConfig.from_json(j.to_json())


@pytest.fixture(scope="module", params=["pallas", "xla"])
def cfgs(request):
    return configs(request.param)


def _pose(yaw, z):
    R = np.asarray(jse3.exp_so3(jnp.asarray([0.0, yaw, 0.0], jnp.float32)))
    return R, (-R @ np.array([0.02 * z / 0.4, 0.0, z], np.float32)).astype(
        np.float32)


class Scene:
    """Points X seen from camera poses k = 0, 1, ... moving 0.4 forward per
    frame; each point keeps one unit descriptor (plus per-view noise)."""

    def __init__(self, seed=0):
        r = np.random.default_rng(seed)
        self.X = r.uniform([-6, -3, 10], [6, 3, 40], (N, 3)).astype(np.float32)
        d = r.standard_normal((N, 128)).astype(np.float32)
        self.desc = d / np.linalg.norm(d, axis=1, keepdims=True)
        self.r = r

    def pose(self, k):
        return _pose(0.003 * k, 0.4 * k)

    def features(self, k):
        """numpy Keypoints fields + descriptors of view k (K slots; the
        visible points in a shuffled order, then invalid slots)."""
        R, t = self.pose(k)
        Xc = self.X @ R.T + t
        u = INTR[0] * Xc[:, 0] / Xc[:, 2] + INTR[2]
        v = INTR[1] * Xc[:, 1] / Xc[:, 2] + INTR[3]
        vis = (u > 2) & (u < 374) & (v > 2) & (v < 238)
        idx = self.r.permutation(np.nonzero(vis)[0])
        n = len(idx)
        yx = np.zeros((K, 2), np.float32)
        yx[:n] = np.stack([v[idx], u[idx]], 1) + self.r.normal(0, 0.2, (n, 2))
        desc = np.zeros((K, 128), np.float32)
        dn = self.desc[idx] + 0.03 * self.r.standard_normal((n, 128))
        desc[:n] = dn / np.linalg.norm(dn, axis=1, keepdims=True)
        valid = np.arange(K) < n
        f = np.zeros(K, np.float32)
        i = np.zeros(K, np.int32)
        kps = (yx, yx.copy(), i, i, f, f, f, valid)
        return kps, desc, idx

    def local_map(self):
        """numpy LocalMap fields: every point, shuffled, slightly moved."""
        order = self.r.permutation(N)
        desc = np.zeros((K, 128), np.float32)
        X = np.zeros((K, 3), np.float32)
        desc[:N] = self.desc[order]
        X[:N] = self.X[order] + self.r.normal(0, 0.01, (N, 3))
        return desc, X, np.arange(K) < N


def _both(kps, desc):
    return (JFeatures(JKeypoints(*(jnp.asarray(a) for a in kps)),
                      jnp.asarray(desc)),
            from_numpy(Features, (kps, desc), device="cpu"))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def scene():
    return Scene()


def _state(scene, k):
    """TrackState of frame k-1 with the true velocity k-2 -> k-1, numpy."""
    Ra, ta = scene.pose(k - 2)
    Rb, tb = scene.pose(k - 1)
    Rr, tr = jse3.compose(jnp.asarray(Rb), jnp.asarray(tb),
                          *jse3.inverse(jnp.asarray(Ra), jnp.asarray(ta)))
    return Rb, tb, np.asarray(jse3.se3_log(Rr, tr))


def test_refine_pose_matches_jax(scene):
    R, t = scene.pose(3)
    Xc = scene.X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:] + scene.r.normal(0, 1e-3, (N, 2))).astype(
        np.float32)
    uv[:20] += 0.05                                     # outliers
    valid = np.arange(N) < N - 10
    xi = np.array([0.01, -0.02, 0.005, 0.1, -0.05, 0.2], np.float32)
    R0, t0 = (np.asarray(a) for a in jse3.se3_exp(jnp.asarray(xi)))
    R0, t0 = R0 @ R, R0 @ t + t0
    args = (R0, t0, scene.X, uv, valid)
    want = jax_refine_pose(*(jnp.asarray(a) for a in args))
    got = refine_pose(*(torch.tensor(a) for a in args))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=POSE_TOL)
    np.testing.assert_array_equal(got.inliers.numpy(), np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 100
    assert got.cost.item() == pytest.approx(float(want.cost), rel=1e-4)
    assert np.abs(got.R.numpy() - R).max() < 1e-3


def test_track_step_lite_matches_jax(scene, cfgs):
    jc, cfg = cfgs
    kps, desc, _ = scene.features(5)
    jf, tf = _both(kps, desc)
    lm = scene.local_map()
    st = _state(scene, 5)
    want = jax.jit(jts.track_step_lite, static_argnums=(4, 5))(
        jts.LocalMap(*(jnp.asarray(a) for a in lm)), jf,
        jts.TrackState(*(jnp.asarray(a) for a in st)), jnp.asarray(INTR),
        jc, OK_MIN)
    got = tts.track_step_lite(from_numpy(tts.LocalMap, lm, device="cpu"), tf,
                              from_numpy(tts.TrackState, st, device="cpu"),
                              torch.tensor(INTR), cfg, OK_MIN)
    want = _np(want)
    assert bool(want.ok) and want.stats[1] > 100
    for name in ("ml_idx_a", "ml_idx_b", "ml_gated", "ml_inlier", "ok"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(want, name), err_msg=name)
    for name in ("R", "t", "vel", "ml_x"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), atol=POSE_TOL,
                                   err_msg=name)
    np.testing.assert_allclose(got.stats.numpy(), want.stats, rtol=1e-4,
                               atol=POSE_TOL)
    R, t = scene.pose(5)
    assert np.abs(got.R.numpy() - R).max() < 1e-3


def _kf_ref(scene, k):
    kps, desc, idx = scene.features(k)
    R, t = scene.pose(k)
    has_lm = np.zeros(K, bool)
    has_lm[: len(idx) // 3] = True
    return (desc, kps[0], kps[7], has_lm, R, t)


def test_keyframe_step_matches_jax(scene, cfgs):
    """Same keyframe, frame and tracked state (the JAX TrackLite carried
    across): same matches, triangulation flags and points."""
    jc, cfg = cfgs
    kps, desc, _ = scene.features(6)
    jf, tf = _both(kps, desc)
    lite = jax.jit(jts.track_step_lite, static_argnums=(4, 5))(
        jts.LocalMap(*(jnp.asarray(a) for a in scene.local_map())), jf,
        jts.TrackState(*(jnp.asarray(a) for a in _state(scene, 6))),
        jnp.asarray(INTR), jc, OK_MIN)
    ref = _kf_ref(scene, 2)
    want = _np(jts.keyframe_step(jts.KeyframeRef(*(jnp.asarray(a)
                                                   for a in ref)),
                                 jf, lite, jnp.asarray(INTR), jc, 200.0))
    got = tts.keyframe_step(from_numpy(tts.KeyframeRef, ref, device="cpu"), tf,
                            from_numpy(tts.TrackLite, _np(lite), device="cpu"),
                            torch.tensor(INTR), cfg, 200.0)
    np.testing.assert_array_equal(got.assoc_i.numpy(), want.assoc_i)
    good = (want.assoc_i[:, 5] & 2) > 0
    assert good.sum() > 10       # most matches are tracked: not fresh
    np.testing.assert_allclose(got.assoc_f.numpy()[:, :6], want.assoc_f[:, :6],
                               atol=1e-6)
    # triangulated points: eigh on each side agrees to a relative ~1e-4 in
    # the eigenvector, which depth / baseline (up to ~30 here) amplifies
    np.testing.assert_allclose(got.assoc_f.numpy()[good, 6:],
                               want.assoc_f[good, 6:], rtol=5e-3, atol=1e-3)
    np.testing.assert_allclose(got.stats.numpy(), want.stats, rtol=1e-4,
                               atol=POSE_TOL)


def test_track_step_is_lite_then_keyframe(scene, cfgs):
    _, cfg = cfgs
    kps, desc, _ = scene.features(6)
    _, tf = _both(kps, desc)
    args = (from_numpy(tts.LocalMap, scene.local_map(), device="cpu"), tf,
            from_numpy(tts.TrackState, _state(scene, 6), device="cpu"),
            torch.tensor(INTR))
    ref = from_numpy(tts.KeyframeRef, _kf_ref(scene, 2), device="cpu")
    full = tts.track_step(ref, *args, cfg, OK_MIN, 200.0)
    lite = tts.track_step_lite(*args, cfg, OK_MIN)
    want = tts.keyframe_step(ref, tf, lite, args[3], cfg, 200.0)
    for a, b in zip(full, want):
        assert torch.equal(a, b)


def test_track_batch_matches_jax(scene, cfgs):
    """Frames 3..7 as one batch with start = 2: frames 3 and 4 pass the
    state through, 5..7 are tracked, in both packages. The streaming 2-NN
    ranks its matches alike in both; the dense matcher's near-ties may
    swap rank, so there each frame's matches are held as a set, and by
    rank only between neighbours RANK_GAP apart."""
    jc, cfg = cfgs
    views = [scene.features(k) for k in range(3, 8)]
    kps = tuple(np.stack([v[0][i] for v in views]) for i in range(8))
    desc = np.stack([v[1] for v in views])
    jf, tf = _both(kps, desc)
    lm = scene.local_map()
    st = _state(scene, 5)
    jst, want = jax.jit(jts.track_batch, static_argnums=(5, 6))(
        jts.LocalMap(*(jnp.asarray(a) for a in lm)), jf, jnp.int32(2),
        jts.TrackState(*(jnp.asarray(a) for a in st)), jnp.asarray(INTR),
        jc, OK_MIN)
    tst, got = tts.track_batch(from_numpy(tts.LocalMap, lm, device="cpu"),
                               tf, 2,
                               from_numpy(tts.TrackState, st, device="cpu"),
                               torch.tensor(INTR), cfg, OK_MIN)
    want = _np(want)
    np.testing.assert_array_equal(got.ok.numpy(), [0, 0, 1, 1, 1])
    np.testing.assert_array_equal(got.ok.numpy(), want.ok)
    fields = ("ml_idx_a", "ml_idx_b", "ml_gated", "ml_inlier")
    if cfg.match.impl == "pallas":
        for name in fields:
            np.testing.assert_array_equal(getattr(got, name).numpy(),
                                          getattr(want, name), err_msg=name)
        tol = POSE_TOL
    else:
        for f in range(len(views)):
            _assert_ranked_alike(
                [getattr(got, n)[f].numpy() for n in fields],
                [getattr(want, n)[f] for n in fields], lm[0], desc[f])
        tol = DENSE_POSE_TOL
    for name in ("R", "t", "vel"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   getattr(want, name), atol=tol,
                                   err_msg=name)
        np.testing.assert_allclose(getattr(tst, name).numpy(),
                                   np.asarray(getattr(jst, name)), atol=tol)
    np.testing.assert_array_equal(got.stats[:2].numpy(), 0.0)
    np.testing.assert_array_equal(got.R[1].numpy(), st[0])
    lite = tts.lite_at(got, 3)
    assert torch.equal(lite.R, got.R[3]) and bool(lite.ok)
    # a 0-d tensor start takes the same path
    _, again = tts.track_batch(from_numpy(tts.LocalMap, lm, device="cpu"), tf,
                               torch.tensor(2),
                               from_numpy(tts.TrackState, st, device="cpu"),
                               torch.tensor(INTR), cfg, OK_MIN)
    assert torch.equal(again.R, got.R)


def _assert_ranked_alike(got, want, map_desc, frame_desc):
    """One frame's matches, fields (idx_a, idx_b, gated, inlier) [M] each,
    against the reference's: the same (idx_a, idx_b, gated, inlier) tuples,
    each at the reference's rank unless it lies in a run of neighbours
    whose distances (float64, from the descriptors) differ by at most
    RANK_GAP relative, where the run's tuples may come in any order."""
    d = ((map_desc[want[0]].astype(np.float64)
          - frame_desc[want[1]]) ** 2).sum(1)
    split = np.abs(np.diff(d)) > RANK_GAP * np.maximum(d[1:], d[:-1])
    run = np.concatenate([[0], np.cumsum(split)])
    g = np.stack(got, 1).astype(np.int64)
    w = np.stack(want, 1).astype(np.int64)
    assert sorted(map(tuple, g)) == sorted(map(tuple, w))
    for r in np.unique(run):
        at = run == r
        assert sorted(map(tuple, g[at])) == sorted(map(tuple, w[at])), r


def test_pack_unpack_keyframe_products_round_trip(scene, cfgs):
    _, cfg = cfgs
    kps, desc, _ = scene.features(6)
    jf, tf = _both(kps, desc)
    args = (from_numpy(tts.LocalMap, scene.local_map(), device="cpu"), tf,
            from_numpy(tts.TrackState, _state(scene, 6), device="cpu"),
            torch.tensor(INTR))
    out = tts.track_step(from_numpy(tts.KeyframeRef, _kf_ref(scene, 2),
                                    device="cpu"),
                         *args, cfg, OK_MIN, 200.0)
    packed = tts.pack_keyframe_products(out, tf)
    M = cfg.match.max_matches
    assert packed.shape == (22 + M * 15 + K * 4,)
    stats, ai, af, yx, resp, valid = tts.unpack_keyframe_products(packed, M, K)
    np.testing.assert_array_equal(stats, out.stats.numpy())
    np.testing.assert_array_equal(ai, out.assoc_i.numpy())
    np.testing.assert_array_equal(af, out.assoc_f.numpy())
    np.testing.assert_array_equal(yx, kps[0])
    np.testing.assert_array_equal(valid, kps[7])
    # the JAX unpacker reads the port's buffer the same way
    for a, b in zip(jts.unpack_keyframe_products(packed.numpy(), M, K),
                    (stats, ai, af, yx, resp, valid)):
        np.testing.assert_array_equal(a, b)
    d = tts.TrackAssoc.unpack(ai, af)
    assert d.tri_good.sum() > 0 and d.lm_inlier.sum() > 100


def _fill_map(ms, scene, views):
    """One sequence of map operations: two keyframes, landmarks, an
    observation set each, a landmark wrap-around, a third keyframe that
    evicts the first."""
    m = ms.SlamMap(window=2, max_landmarks=150, feat_capacity=K)
    for k, lm_range in ((0, slice(0, 100)), (1, slice(50, 140)),
                        (2, slice(20, 150))):
        kps, desc, _ = views[k]
        R, t = scene.pose(k)
        slot, _ = m.allocate_keyframe()
        m.set_keyframe(slot, k, R, t, desc, kps[0], kps[7])
        if k == 0:
            lm = m.allocate_landmarks(scene.X[:100])
        else:
            lm = np.arange(150)[lm_range]
            m.allocate_landmarks(scene.X[100:150][:lm_range.stop - 140])
        n = min(len(lm), int(kps[7].sum()))
        m.add_observations(slot, lm[:n], kps[0][:n, ::-1] / 100.0)
        m.kf_kp_lm[slot][:n] = lm[:n]
    return m


def test_map_copy_and_local_map_equal_jax(scene):
    views = [scene.features(k) for k in range(3)]
    jm, tm = _fill_map(jms, scene, views), _fill_map(tms, scene, views)
    assert len(jm.archive) == len(tm.archive) == 1
    for a, b in zip(jm.build_ba_arrays(400), tm.build_ba_arrays(400)):
        np.testing.assert_array_equal(a, b)
    want, jids = jts.build_local_map(jm, K, 128, np.float32)
    got, ids = tts.build_local_map(tm, K, 128, np.float32,
                                    device="cpu")
    np.testing.assert_array_equal(ids, jids)
    assert (ids >= 0).sum() > 40
    for name in ("desc", "X", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)))

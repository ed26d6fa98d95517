"""Two-view geometry in both packages on the same inputs: the 8-point
solver, Sampson error, essential decomposition and pose recovery on noisy
synthetic correspondences, RANSAC and relative-pose estimation with the
reference's random samples replayed into the port (jax.random's bits
cannot be drawn in torch), and two-view init from injected features."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.geometry import epipolar as jep
from visualslam_tpu.geometry import ransac as jrs
from visualslam_tpu.geometry.se3 import exp_so3 as jexp_so3
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.slam import two_view as jtv
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.geometry import epipolar as tep
from visualslam_tpu_torch.geometry import ransac as trs
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.slam import two_view as ttv
from visualslam_tpu_torch.utils.config import SlamConfig

RCFG = jcfg.RansacConfig(num_hypotheses=128, inlier_threshold=5e-5)

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _pose(rng):
    w = rng.normal(0, 0.05, 3)
    R = np.asarray(jexp_so3(jnp.asarray(w, jnp.float32)))
    t = np.array([0.6, 0.05, 0.1]) + rng.normal(0, 0.02, 3)
    return R.astype(np.float32), t.astype(np.float32)


def correspondences(rng, n=200, M=256, noise=1e-3, outliers=0.2):
    """[M, 2] normalized correspondences (x1, x2), valid mask, and the
    pose (R, t): n points in front of both cameras with noise, a share of
    them replaced by outliers, the rest of M invalid."""
    R, t = _pose(rng)
    X = rng.uniform([-4, -3, 6], [4, 3, 20], (n, 3))
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = X2[:, :2] / X2[:, 2:]
    x1 = x1 + rng.normal(0, noise, x1.shape)
    x2 = x2 + rng.normal(0, noise, x2.shape)
    bad = rng.random(n) < outliers
    x2[bad] = rng.uniform(-0.4, 0.4, (int(bad.sum()), 2))
    a = np.zeros((M, 2), np.float32)
    b = np.zeros((M, 2), np.float32)
    a[:n], b[:n] = x1, x2
    valid = np.arange(M) < n
    return a, b, valid, R, t


def _up_to_sign(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return a if np.abs(a - b).sum() <= np.abs(a + b).sum() else -a, b


def test_eight_point_and_sampson_match_jax(rng):
    x1, x2, _, _, _ = correspondences(rng, n=60, M=60, outliers=0.0)
    w = (rng.random(60) > 0.1).astype(np.float32)
    Ej = np.asarray(jep.eight_point(jnp.asarray(x1), jnp.asarray(x2),
                                    jnp.asarray(w)))
    Et = tep.eight_point(torch.tensor(x1), torch.tensor(x2),
                         torch.tensor(w)).numpy()
    # E is defined up to sign (eigen / singular vectors). The smallest
    # eigenvector of the float32 9x9 normal matrix carries eps x cond^2:
    # here the reference's own E is 1.8e-4 off a float64 solve of the same
    # problem and the port's 1.4e-5, so the port is held to the float64
    # solve within 1e-4 and to the reference within 5e-4
    E64 = tep.eight_point(torch.tensor(x1).double(), torch.tensor(x2).double(),
                          torch.tensor(w).double()).numpy()
    a, b = _up_to_sign(Et, E64)
    np.testing.assert_allclose(a, b, atol=1e-4)
    a, b = _up_to_sign(Et, Ej)
    np.testing.assert_allclose(a, b, atol=5e-4)
    # batched over hypotheses, as RANSAC calls it: each minimal sample's
    # solve equals its unbatched solve; a minimal 8-point system is worse
    # conditioned, and both packages' float32 solves sit up to ~0.02 from
    # a float64 solve of the same sample (measured worst: 0.0175 port,
    # 0.0027 reference), so each is held to the float64 solve within 0.05
    x8 = torch.tensor(x1[:24]).reshape(3, 8, 2)
    y8 = torch.tensor(x2[:24]).reshape(3, 8, 2)
    Eb = tep.eight_point(x8, y8).numpy()
    for k in range(3):
        a, b = _up_to_sign(Eb[k], tep.eight_point(x8[k], y8[k]).numpy())
        np.testing.assert_allclose(a, b, atol=1e-5)
        e64 = tep.eight_point(x8[k].double(), y8[k].double()).numpy()
        ej = np.asarray(jep.eight_point(jnp.asarray(x8[k].numpy()),
                                        jnp.asarray(y8[k].numpy())))
        for e in (Eb[k], ej):
            a, b = _up_to_sign(e, e64)
            np.testing.assert_allclose(a, b, atol=0.05)
    # the Sampson error of one E in both packages: same float32 formula
    se_j = np.asarray(jep.sampson_error(jnp.asarray(Ej), jnp.asarray(x1),
                                        jnp.asarray(x2)))
    se_t = tep.sampson_error(torch.tensor(Ej), torch.tensor(x1),
                             torch.tensor(x2)).numpy()
    np.testing.assert_allclose(se_t, se_j, rtol=1e-5, atol=1e-12)


def test_decompose_and_recover_pose_match_jax(rng):
    x1, x2, valid, R_gt, t_gt = correspondences(rng, n=120, M=128,
                                                outliers=0.0)
    E = np.asarray(jep.eight_point(jnp.asarray(x1[:120]),
                                   jnp.asarray(x2[:120])))
    (R1j, R2j), tj = jep.decompose_essential(jnp.asarray(E))
    (R1t, R2t), tt = tep.decompose_essential(torch.tensor(E))
    # the twisted pair as a set, t up to sign (singular-vector freedom)
    got = sorted([R1t.numpy(), R2t.numpy()], key=lambda r: r[0, 0])
    want = sorted([np.asarray(R1j), np.asarray(R2j)], key=lambda r: r[0, 0])
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=1e-5)
    np.testing.assert_allclose(np.abs(tt.numpy()), np.abs(np.asarray(tj)),
                               atol=1e-5)
    w = valid.astype(np.float32)
    Rj, tj, Xj, fj = (np.asarray(v) for v in jep.recover_pose(
        jnp.asarray(E), jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(w)))
    Rt, tt, Xt, ft = (v.numpy() for v in tep.recover_pose(
        torch.tensor(E), torch.tensor(x1), torch.tensor(x2),
        torch.tensor(w)))
    # the chosen pose is unique: rotation and unit translation to 1e-5,
    # the cheirality mask equal, points (triangulated by float32 4x4 eigh)
    # to 1e-3 relative
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_array_equal(ft, fj)
    np.testing.assert_allclose(Xt[fj], Xj[fj], rtol=1e-3, atol=1e-4)
    assert np.degrees(np.arccos(np.clip(
        (np.trace(Rt @ R_gt.T) - 1) / 2, -1, 1))) < 0.5


def replay(key, valid, N, n):
    """The reference's sample indices for key (ransac.py:39, 56): one
    Gumbel top-k per split key."""
    keys = jax.random.split(key, N)
    return np.asarray(jax.vmap(
        lambda k: jrs._gumbel_sample_indices(k, jnp.asarray(valid), n))(keys))


@pytest.fixture()
def replayed(monkeypatch):
    """Point the port's sampler at a queue of replayed draws."""
    queue = []

    def sample(gen, valid, N, n):
        return torch.as_tensor(queue.pop(0), device=valid.device)

    monkeypatch.setattr(trs, "sample_indices", sample)
    return queue


@pytest.mark.parametrize("seed", [0, 1])
def test_ransac_with_replayed_samples_matches_jax(replayed, seed):
    rng = np.random.default_rng(seed)
    x1, x2, valid, R_gt, _ = correspondences(rng)
    key = jax.random.PRNGKey(seed)
    args = (jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid))
    Ej, inlj, nj = jrs.ransac_essential(*args, RCFG, key)
    replayed.append(replay(key, valid, RCFG.num_hypotheses,
                           RCFG.sample_size))
    targs = (torch.tensor(x1), torch.tensor(x2), torch.tensor(valid))
    cfg = SlamConfig.from_json(jcfg.SlamConfig(ransac=RCFG).to_json()).ransac
    Et, inlt, nt = trs.ransac_essential(*targs, cfg)
    # same samples, same winner, the same inlier set (no correspondence
    # sits within float32 noise of the threshold). The winner here is a
    # minimal-sample solve (the refit counts fewer inliers): its float32 E
    # is held within 0.05 of the reference's, as in
    # test_eight_point_and_sampson_match_jax
    np.testing.assert_array_equal(inlt.numpy(), np.asarray(inlj))
    assert int(nt) == int(nj) > 100
    a, b = _up_to_sign(Et.numpy(), np.asarray(Ej))
    np.testing.assert_allclose(a, b, atol=0.05)

    Rj, tj, Xj, mj, cj = jrs.estimate_relative_pose(*args, RCFG, key)
    replayed.append(replay(key, valid, RCFG.num_hypotheses,
                           RCFG.sample_size))
    Rt, tt, Xt, mt, ct = trs.estimate_relative_pose(*targs, cfg)
    np.testing.assert_array_equal(mt.numpy(), np.asarray(mj))
    assert int(ct) == int(cj)
    # the pose recovered from those two E carries the minimal solve's
    # float32 noise (measured over the tests: rotations up to 0.03 deg,
    # unit translations up to 2.2e-4, point depths a median 0.46% apart and
    # 8% at the 95th percentile, low-parallax points): rotation within 0.1
    # deg, translation within 5e-3, points by relative error, median within
    # 1e-2 and 95% within 0.2
    dR = Rt.numpy() @ np.asarray(Rj).T
    ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
    dt = np.abs(tt.numpy() - np.asarray(tj)).max()
    m = np.asarray(mj)
    dX = (np.linalg.norm(Xt.numpy()[m] - np.asarray(Xj)[m], axis=1)
          / np.linalg.norm(np.asarray(Xj)[m], axis=1))
    assert ang < 0.1 and dt < 5e-3, (ang, dt)
    assert np.median(dX) < 1e-2 and np.quantile(dX, 0.95) < 0.2


def test_port_sampler_draws_distinct_valid_indices():
    valid = torch.zeros(64, dtype=torch.bool)
    valid[::3] = True
    idx = trs.sample_indices(trs.generator(0, "cpu"), valid, 50, 8)
    assert idx.shape == (50, 8)
    assert bool(valid[idx].all())
    assert all(len(set(r.tolist())) == 8 for r in idx)
    again = trs.sample_indices(trs.generator(0, "cpu"), valid, 50, 8)
    assert torch.equal(idx, again)



def test_two_view_from_features_matches_jax(rng, replayed):
    """Injected features of two views of one point cloud (64-D unit
    descriptors, 0.3 px noise) through both packages' two-view init."""
    n, cap = 300, 384
    R, t = _pose(rng)
    X = rng.uniform([-6, -4, 8], [6, 4, 30], (n, 3))
    desc = rng.standard_normal((n, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    intr = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    feats = []
    for k, (Rk, tk) in enumerate(((np.eye(3), np.zeros(3)), (R, t))):
        Xc = X @ Rk.T + tk
        px = Xc[:, :2] / Xc[:, 2:] * intr[:2] + intr[2:]
        px = px + rng.normal(0, 0.3, px.shape)
        yx = np.zeros((cap, 2), np.float32)
        yx[:n] = px[:, ::-1]
        d = np.zeros((cap, 64), np.float32)
        # the second view's descriptors carry noise, so that match
        # distances are distinct and rank alike in both packages
        d[:n] = desc + k * rng.normal(0, 0.05, desc.shape)
        feats.append((yx, d, np.arange(cap) < n))
    jc = jcfg.DEFAULT_CONFIG.replace(
        match=jcfg.DEFAULT_CONFIG.match.replace(max_matches=256),
        ransac=RCFG.replace(inlier_threshold=2e-5))
    cfg = SlamConfig.from_json(jc.to_json())
    jf = [JFeatures(JKeypoints.empty(cap)._replace(
        yx=jnp.asarray(yx), valid=jnp.asarray(v)), jnp.asarray(d))
        for yx, d, v in feats]
    tf = [Features(Keypoints.empty(cap)._replace(
        yx=torch.tensor(yx), valid=torch.tensor(v)), torch.tensor(d))
        for yx, d, v in feats]
    key = jax.random.PRNGKey(3)
    ref = jtv.two_view_from_features(*jf, jnp.asarray(intr), jc, key)
    replayed.append(replay(key, np.asarray(ref.matches.valid),
                           jc.ransac.num_hypotheses, jc.ransac.sample_size))
    got = ttv.two_view_from_features(*tf, torch.tensor(intr), cfg)
    np.testing.assert_array_equal(got.matches.idx_a.numpy(),
                                  np.asarray(ref.matches.idx_a))
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(ref.inliers))
    assert int(got.num_inliers) == int(ref.num_inliers) > 200
    # as in the RANSAC test: rotation within 0.1 deg, translation 5e-3
    dR = got.R.numpy() @ np.asarray(ref.R).T
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 0.1
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-3)

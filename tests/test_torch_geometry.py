"""The port's SE(3), camera and triangulation against the JAX package, on
one numpy input fed to both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.geometry import camera as jcam
from visualslam_tpu.geometry import se3 as jse3
from visualslam_tpu.geometry.epipolar import triangulate as jax_triangulate
from visualslam_tpu_torch.geometry import camera as tcam
from visualslam_tpu_torch.geometry import se3 as tse3
from visualslam_tpu_torch.geometry.epipolar import triangulate

# float32 Rodrigues / arccos evaluated by two libraries: a few ulps of the
# unit-scale entries
ATOL = 2e-6


def _twists(rng, angles):
    """[N, 6] twists whose rotation parts have the given angles."""
    axis = rng.standard_normal((len(angles), 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    w = axis * np.asarray(angles)[:, None]
    return np.concatenate([w, rng.standard_normal((len(angles), 3))],
                          1).astype(np.float32)


# small angles take the Taylor branch (|w|^2 < 1e-8), mid angles the closed
# form, angles within 1e-3 of pi the diagonal axis recovery of log_so3
ANGLES = {"small": [0.0, 1e-6, 5e-5, 9e-5],
          "mid": [0.1, 0.7, 1.5, 2.5],
          "near_pi": [np.pi - 5e-4, np.pi - 1e-4, np.pi]}


@pytest.mark.parametrize("regime", sorted(ANGLES))
def test_se3_exp_and_log_match_jax(rng, regime):
    xi = _twists(rng, ANGLES[regime])
    R, t = tse3.se3_exp(torch.from_numpy(xi))
    jR, jt = jse3.se3_exp(jnp.asarray(xi))
    np.testing.assert_allclose(R.numpy(), np.asarray(jR), atol=ATOL)
    np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=ATOL)
    # log of the JAX rotation in both packages
    w = tse3.log_so3(torch.tensor(np.asarray(jR)))
    jw = jse3.log_so3(jR)
    # near pi the axis is recovered from sqrt((diag + 1) / 2): an ulp of
    # the diagonal moves it by ~ulp / sqrt(2 (1 + cos)), ~1e-4 rad there
    tol = 2e-4 if regime == "near_pi" else 1e-5
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=tol)
    v = tse3.se3_log(torch.tensor(np.asarray(jR)),
                     torch.tensor(np.asarray(jt)))
    if regime != "near_pi":     # V^-1 is singular at pi in both packages
        np.testing.assert_allclose(v.numpy(), xi, atol=5e-5)
        np.testing.assert_allclose(
            v.numpy(), np.asarray(jse3.se3_log(jR, jt)), atol=1e-5)


def test_exp_so3_round_trip(rng):
    w = _twists(rng, [0.0, 1e-5, 0.3, 1.2, 3.0])[:, :3]
    R = tse3.exp_so3(torch.from_numpy(w))
    np.testing.assert_allclose(R.numpy(), np.asarray(jse3.exp_so3(
        jnp.asarray(w))), atol=ATOL)
    np.testing.assert_allclose(tse3.log_so3(R).numpy(), w, atol=2e-5)
    eye = R @ R.transpose(-1, -2)
    np.testing.assert_allclose(eye.numpy(), np.broadcast_to(np.eye(3), eye.shape),
                               atol=1e-6)


def test_compose_inverse_transform_relative(rng):
    xa, xb = _twists(rng, [0.4, 1.1]), _twists(rng, [0.9, 0.2])
    Ra, ta = tse3.se3_exp(torch.from_numpy(xa))
    Rb, tb = tse3.se3_exp(torch.from_numpy(xb))
    jRa, jta = jse3.se3_exp(jnp.asarray(xa))
    jRb, jtb = jse3.se3_exp(jnp.asarray(xb))
    X = rng.standard_normal((2, 3)).astype(np.float32)
    for got, want in (
            (tse3.compose(Ra, ta, Rb, tb), jse3.compose(jRa, jta, jRb, jtb)),
            (tse3.inverse(Ra, ta), jse3.inverse(jRa, jta)),
            (tse3.relative(Ra, ta, Rb, tb), jse3.relative(jRa, jta, jRb, jtb)),
            ((tse3.transform(Ra, ta, torch.from_numpy(X)),),
             (jse3.transform(jRa, jta, jnp.asarray(X)),))):
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    # T . T^-1 = I
    Ri, ti = tse3.inverse(Ra, ta)
    Rc, tc = tse3.compose(Ra, ta, Ri, ti)
    np.testing.assert_allclose(Rc.numpy(), np.broadcast_to(np.eye(3), (2, 3, 3)),
                               atol=1e-6)
    np.testing.assert_allclose(tc.numpy(), 0.0, atol=1e-5)


def test_camera_project_unproject_normalized(rng):
    intr = np.array([225.6, 225.6, 188.0, 120.0], np.float32)
    X = rng.uniform([-3, -2, 4], [3, 2, 30], (50, 3)).astype(np.float32)
    uv = tcam.project(torch.from_numpy(X), torch.from_numpy(intr))
    np.testing.assert_allclose(uv.numpy(), np.asarray(jcam.project(
        jnp.asarray(X), jnp.asarray(intr))), rtol=1e-6, atol=1e-4)
    ray = tcam.unproject(uv, torch.from_numpy(intr))
    np.testing.assert_allclose(ray.numpy() * X[:, 2:], X, rtol=1e-5, atol=1e-5)
    xn = tcam.normalized(uv, torch.from_numpy(intr))
    np.testing.assert_allclose(xn.numpy(), np.asarray(jcam.normalized(
        jnp.asarray(uv.numpy()), jnp.asarray(intr))), atol=1e-7)


def test_triangulate_matches_jax(rng):
    xi = _twists(rng, [0.05])[0] * np.array([1, 1, 1, 0.2, 0.2, 0.2],
                                            np.float32)
    R, t = (a.numpy() for a in tse3.se3_exp(torch.from_numpy(xi)))
    X = rng.uniform([-3, -2, 4], [3, 2, 30], (64, 3)).astype(np.float32)
    x1 = X[:, :2] / X[:, 2:]
    X2 = X @ R.T + t
    x2 = (X2[:, :2] / X2[:, 2:]).astype(np.float32)
    got = triangulate(*(torch.from_numpy(a) for a in (R, t, x1, x2)))
    want = np.asarray(jax_triangulate(*(jnp.asarray(a) for a in (R, t, x1,
                                                                 x2))))
    # both packages take eigh of the same float32 normal matrix: the
    # eigenvector, and hence the point, agrees to a relative ~1e-4 at a
    # 0.2-unit baseline and depths up to 30
    rel = np.linalg.norm(got.numpy() - want, axis=1) / np.linalg.norm(X, axis=1)
    assert rel.max() < 1e-3
    rel_gt = np.linalg.norm(got.numpy() - X, axis=1) / np.linalg.norm(X, axis=1)
    assert np.median(rel_gt) < 1e-3

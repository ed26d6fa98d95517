"""The injected-feature scene of tests/test_tracker.py (a static point
cloud, a forward path with a gentle turn, descriptors per point), built
with numpy only, for the tracker tests of both packages."""

import numpy as np

from visualslam_tpu.utils.config import DEFAULT_CONFIG

INTR = np.array([500.0, 500.0, 320.0, 240.0], np.float32)
W, H = 640, 480

CFG = DEFAULT_CONFIG.replace(
    keyframe_min_inliers=40,
    keyframe_max_gap=4,
    match=DEFAULT_CONFIG.match.replace(max_matches=512, ratio=0.9),
    ransac=DEFAULT_CONFIG.ransac.replace(num_hypotheses=256,
                                         inlier_threshold=5e-5),
    ba=DEFAULT_CONFIG.ba.replace(max_cameras=6, max_landmarks=2048,
                                 max_observations=8192, iters=6),
)


def exp_so3(w: np.ndarray) -> np.ndarray:
    """Rodrigues in float64."""
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        return np.eye(3) + K
    return (np.eye(3) + np.sin(th) / th * K
            + (1 - np.cos(th)) / th ** 2 * K @ K)


class SyntheticScene:
    """Static point cloud + camera path; numpy features per frame:
    (yx [cap, 2], desc [cap, 64], valid [cap]) and the world-to-camera
    pose. max_depth must cover the camera's travel (z ~ 0.45/frame)."""

    def __init__(self, rng, n_points=600, cap=1024, max_depth=40.0):
        self.rng = rng
        self.cap = cap
        self.X = rng.uniform([-12, -6, 8], [12, 6, max_depth],
                             (n_points, 3))
        self.desc = rng.standard_normal((n_points, 64)).astype(np.float32)
        self.desc /= np.linalg.norm(self.desc, axis=1, keepdims=True)

    def pose(self, k):
        """Forward motion with a gentle turn (world-to-camera)."""
        R = exp_so3(np.array([0.0, 0.004 * k, 0.0]))
        center = np.array([0.05 * k * k * 0.05, 0.0, 0.45 * k])
        t = -R @ center
        return R.astype(np.float32), t.astype(np.float32)

    def features(self, k, pix_noise=0.3):
        R, t = self.pose(k)
        Xc = self.X @ R.T + t
        z = Xc[:, 2]
        uv = Xc[:, :2] / np.maximum(z[:, None], 1e-6)
        px = uv * INTR[:2] + INTR[2:]
        vis = (z > 1.0) & (px[:, 0] >= 5) & (px[:, 0] < W - 5) \
            & (px[:, 1] >= 5) & (px[:, 1] < H - 5)
        idx = np.nonzero(vis)[0][: self.cap]
        n = len(idx)
        px_n = px[idx] + self.rng.normal(0, pix_noise, (n, 2))
        yx = np.zeros((self.cap, 2), np.float32)
        yx[:n] = px_n[:, ::-1]
        desc = np.zeros((self.cap, 64), np.float32)
        desc[:n] = self.desc[idx]
        valid = np.zeros(self.cap, bool)
        valid[:n] = True
        return (yx, desc, valid), (R, t)


def garbage(rng, cap=1024):
    """Features of a frame that matches nothing (tracking loss)."""
    desc = rng.standard_normal((cap, 64)).astype(np.float32)
    desc /= np.linalg.norm(desc, axis=1, keepdims=True)
    yx = rng.uniform(10, 400, (cap, 2)).astype(np.float32)
    return yx, desc, np.ones(cap, bool)


def gt_pose(R, t) -> np.ndarray:
    """[3, 4] camera-to-world of a world-to-camera pose."""
    return np.concatenate([R.T, (-R.T @ t)[:, None]], 1)

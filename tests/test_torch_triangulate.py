"""The DLT triangulation kernel's arithmetic (ops/cuda/triangulate.py,
csrc/triangulate.cu) against the JAX package's `triangulate`
(jnp.linalg.eigh), on the CPU.

The kernel cannot run here; `triangulate_jacobi` repeats its operations in
float32 (the card's tests hold the kernel to it bit for bit). Inputs: seeded
numpy scenes (baselines from 0.01 to 1, depths from 1 to 1000, pixel-scale
noise) and a keyframe pair of the synthetic sequence. Comparisons are
gated by each normal matrix's relative eigengap: at gaps >= GAP_MIN the unit
eigenvectors agree within VEC_TOL x eps32 / gap; the points and the
keyframe gates (slam/track_step.keyframe_step's tri_good) follow."""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.geometry.epipolar import triangulate as jax_triangulate
from visualslam_tpu_torch.geometry import se3
from visualslam_tpu_torch.geometry.epipolar import triangulate
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.ops.cuda import KERNELS, PLAIN
from visualslam_tpu_torch.ops.cuda import triangulate as tri

F32 = np.float32
MAX_DEPTH = 400.0
# keyframe_step's gates: depth in both cameras above 1e-3, below max_depth
# in the first, reprojection residual below 6e-3 in both
Z_MIN, R_MAX = 1e-3, 6e-3


def _scene(seed, n, base, depth, noise):
    """(R, t, x1, x2) float32: n points in front of camera 1 at depths
    uniform in `depth`, a small random rotation and a baseline of `base`,
    normalized coordinates with Gaussian noise of `noise`."""
    r = np.random.default_rng(seed)
    ax = r.normal(size=3)
    ax *= 0.05 / np.linalg.norm(ax)
    R = se3.se3_exp(torch.tensor(np.r_[ax, 0, 0, 0], dtype=torch.float32))[0]
    t = r.normal(size=3)
    t *= base / np.linalg.norm(t)
    z = r.uniform(*depth, n)
    X = np.c_[r.uniform(-0.6, 0.6, (n, 2)) * z[:, None], z]
    X2 = X @ R.numpy().T + t
    x1 = X[:, :2] / X[:, 2:] + r.normal(size=(n, 2)) * noise
    x2 = X2[:, :2] / X2[:, 2:] + r.normal(size=(n, 2)) * noise
    return R.numpy().astype(F32), t.astype(F32), x1.astype(F32), \
        x2.astype(F32)


def _sequence_pair(a=0, b=8):
    """Keyframes a and b of the synthetic sequence: its dots visible in
    both (in front, inside the image), half-pixel noise."""
    seq = SyntheticSequence(num_frames=b + 1, h=240, w=376, n_dots=4000)
    fx, fy, cx, cy = seq.intrinsics
    r = np.random.default_rng(5)

    def cam(k):
        Rc, c = seq.gt_poses[k][:, :3], seq.gt_poses[k][:, 3]
        return Rc.T, -Rc.T @ c

    (R1, t1), (R2, t2) = cam(a), cam(b)
    X1, X2 = seq.X @ R1.T + t1, seq.X @ R2.T + t2
    u1 = X1[:, :2] / X1[:, 2:]
    u2 = X2[:, :2] / X2[:, 2:]
    inside = ((X1[:, 2] > 0.1) & (X2[:, 2] > 0.1)
              & (np.abs(u1[:, 0]) < cx / fx) & (np.abs(u1[:, 1]) < cy / fy)
              & (np.abs(u2[:, 0]) < cx / fx) & (np.abs(u2[:, 1]) < cy / fy))
    x1 = u1[inside] + r.normal(size=(inside.sum(), 2)) * 0.5 / fx
    x2 = u2[inside] + r.normal(size=(inside.sum(), 2)) * 0.5 / fx
    Rr = R2 @ R1.T
    return (Rr.astype(F32), (t2 - Rr @ t1).astype(F32), x1.astype(F32),
            x2.astype(F32))


CASES = {
    "kitti_like": (0, 2048, 0.4, (2, 40), 1e-3),
    "small_baseline": (1, 2048, 0.05, (2, 200), 1e-3),
    "noise_free": (2, 2048, 1.0, (1, 10), 0.0),
    "near_infinity": (3, 2048, 0.01, (5, 1000), 2e-3),
}


@pytest.fixture(scope="module", params=list(CASES) + ["sequence"])
def case(request):
    if request.param == "sequence":
        return _sequence_pair()
    return _scene(*CASES[request.param])


def _torch(*a):
    return [torch.from_numpy(np.ascontiguousarray(x)) for x in a]


def _jax_vectors(X):
    """Unit 4-vectors (w > 0) of the JAX package's points, in float64."""
    h = np.c_[np.asarray(X, np.float64), np.ones(len(X))]
    return h / np.linalg.norm(h, axis=1, keepdims=True)


def _gates(X, R, t, x1, x2):
    """keyframe_step's acceptance quantities of points X (camera 1):
    (z1, z2, r1, r2) in float64."""
    X = np.asarray(X, np.float64)
    X2 = X @ np.asarray(R, np.float64).T + t
    z1, z2 = X[:, 2], X2[:, 2]
    r1 = np.linalg.norm(X[:, :2] / np.maximum(z1, 1e-6)[:, None] - x1, axis=1)
    r2 = np.linalg.norm(X2[:, :2] / np.maximum(z2, 1e-6)[:, None] - x2,
                        axis=1)
    return z1, z2, r1, r2


def _good(z1, z2, r1, r2):
    return ((z1 > Z_MIN) & (z2 > Z_MIN) & (z1 < MAX_DEPTH) & (r1 < R_MAX)
            & (r2 < R_MAX))


def test_replay_matches_jax_under_the_gap_gate(case):
    """The kernel's Jacobi (replayed in float32) against jnp.linalg.eigh:
    unit eigenvectors within VEC_TOL * eps32 / gap at gaps >= GAP_MIN."""
    R, t, x1, x2 = case
    got, v = tri.triangulate_jacobi(*_torch(R, t, x1, x2), vectors=True)
    want = np.asarray(jax_triangulate(*map(jnp.asarray, (R, t, x1, x2))))
    assert got.dtype == torch.float32 and got.shape == (len(x1), 3)
    gap = tri.eigen_gap(tri.normal_matrices(*_torch(R, t, x1, x2)).numpy())
    n, worst, bound = tri.compare_solvers(v.numpy(), _jax_vectors(want), gap)
    assert n >= 0.9 * len(x1) and worst <= bound, (n, worst)
    # where w is well away from 0 the points follow: |dX| <= |dv| (1 + |X|)
    # / w, with |dv| at its bound
    h = _jax_vectors(want)
    gate = (gap >= tri.GAP_MIN) & (h[:, 3] > 1e-3)
    tol = (bound * tri.EPS32 / gap[gate] * (1 + np.linalg.norm(want[gate], axis=1))
           / h[gate, 3])
    err = np.linalg.norm(got.numpy()[gate].astype(np.float64) - want[gate],
                         axis=1)
    assert (err <= tol).all(), float((err / tol).max())


def test_replay_agrees_with_the_plain_version(case):
    """The same gate against the port's plain version (torch eigh)."""
    R, t, x1, x2 = _torch(*case)
    _, v = tri.triangulate_jacobi(R, t, x1, x2, vectors=True)
    gap = tri.eigen_gap(tri.normal_matrices(R, t, x1, x2).numpy())
    n, worst, bound = tri.compare_solvers(
        v.numpy(), tri.unit_vectors_ref(R, t, x1, x2).numpy(), gap)
    assert n >= 0.9 * len(x1) and worst <= bound, (n, worst)


def test_keyframe_gates_agree_off_their_thresholds(case):
    """tri_good from the replay's points and from the JAX package's: equal
    at every point of gap >= GAP_MIN but where a gated quantity lies
    within its difference between the two of its threshold."""
    R, t, x1, x2 = case
    got = tri.triangulate_jacobi(*_torch(R, t, x1, x2)).numpy()
    want = np.asarray(jax_triangulate(*map(jnp.asarray, (R, t, x1, x2))))
    qa, qb = _gates(got, R, t, x1, x2), _gates(want, R, t, x1, x2)
    gap = tri.eigen_gap(tri.normal_matrices(*_torch(R, t, x1, x2)).numpy())
    near = np.zeros(len(x1), bool)
    for a, b, thr in zip(qa, qb, (Z_MIN, Z_MIN, R_MAX, R_MAX)):
        near |= np.abs(b - thr) <= np.abs(a - b)
    near |= np.abs(qb[0] - MAX_DEPTH) <= np.abs(qa[0] - qb[0])
    differ = _good(*qa) != _good(*qb)
    assert not (differ & (gap >= tri.GAP_MIN) & ~near).any()
    assert _good(*qb).sum() > 0.2 * len(x1)


def test_sweeps_reach_float32_rounding(case):
    """After SWEEPS - 1 sweeps every off-diagonal norm is below float32
    rounding of its matrix, and SWEEPS + 2 sweeps change no bit."""
    R, t, x1, x2 = _torch(*case)
    offs = []
    X = tri.triangulate_jacobi(R, t, x1, x2, sweeps=tri.SWEEPS + 2,
                               offs=offs)
    assert float(offs[tri.SWEEPS - 2].max()) < tri.EPS32
    assert torch.equal(tri.triangulate_jacobi(R, t, x1, x2), X)


# SHA-256 of triangulate_jacobi's points on _pinned_scene(), recorded before
# the kernel moved to four lanes per point: the replay keeps its bits, so a
# kernel held to it bit for bit keeps them too
REPLAY_DIGEST = "3dbafd3800a83f2bab473167b289fbaa79f790a0a3b21f61b675a9d1ba386669"


def _pinned_scene(n=64):
    """(R, t, x1, x2) float32 tensors from seeded float64 numpy made with
    elementwise operations and square roots alone (no BLAS, no
    transcendentals, so the same bits on any CPU): a rotation from a
    normalized quaternion, points at depths 2..40, uniform noise of 1e-3."""
    r = np.random.default_rng(64)
    q = np.r_[1.0, r.uniform(-0.03, 0.03, 3)]
    w, x, y, z = q / np.sqrt((q * q).sum())
    R = np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)]])
    t = np.array([0.4, 0.05, -0.02])
    depth = r.uniform(2.0, 40.0, n)
    X = np.stack([r.uniform(-0.6, 0.6, n) * depth,
                  r.uniform(-0.6, 0.6, n) * depth, depth], 1)
    X2 = (R[None, :, 0] * X[:, :1] + R[None, :, 1] * X[:, 1:2]
          + R[None, :, 2] * X[:, 2:] + t)
    x1 = X[:, :2] / X[:, 2:] + r.uniform(-1e-3, 1e-3, (n, 2))
    x2 = X2[:, :2] / X2[:, 2:] + r.uniform(-1e-3, 1e-3, (n, 2))
    return tuple(torch.from_numpy(a.astype(F32)) for a in (R, t, x1, x2))


def test_replay_bits_are_pinned():
    """triangulate_jacobi gives the recorded bits on a seeded scene."""
    X = tri.triangulate_jacobi(*_pinned_scene())
    assert hashlib.sha256(X.numpy().tobytes()).hexdigest() == REPLAY_DIGEST


def test_wrapper_on_the_cpu_is_the_plain_version():
    """On CPU tensors the wrapper runs the plain version (and launches
    nothing); epipolar.triangulate goes through the kernel set it is
    given."""
    R, t, x1, x2 = _torch(*_scene(9, 64, 0.4, (2, 40), 1e-3))
    before = tri.triangulate_dlt.launches
    want = tri.triangulate_ref(R, t, x1, x2)
    assert torch.equal(tri.triangulate_dlt(R, t, x1, x2), want)
    assert torch.equal(triangulate(R, t, x1, x2, KERNELS), want)
    assert torch.equal(triangulate(R, t, x1, x2, PLAIN), want)
    assert tri.triangulate_dlt.launches == before
    assert KERNELS.triangulate_dlt is tri.triangulate_dlt
    assert PLAIN.triangulate_dlt is tri.triangulate_ref


def test_wrapper_rejects_mixed_devices():
    R, t, x1, x2 = _torch(*_scene(9, 8, 0.4, (2, 40), 1e-3))
    with pytest.raises(ValueError):
        tri.triangulate_dlt(R.to("meta"), t, x1, x2)

"""The two-view solvers' small-matrix kernels (ops/cuda/small_linalg.py:
`sym_eigh`, float32 in and out with float64 inside, and `svd3`, float32)
through their replays, which repeat the card's arithmetic bit for bit,
against the JAX package's float32 `jnp.linalg.eigh` / `svd`
and on the two-view path (8-point, five-point, RANSAC and pose recovery
under the reference's replayed draws); the "ransac" and two-view programs
against their eager functions on the CPU; and the port's package surface
against the JAX package's re-exports.

Eigenvectors are compared where float32 fixes them: eigenvalues within
EIG_TOL x max |lambda|, and the projector onto each cluster of eigenvalues
(neighbours closer than GAP_MIN x max |lambda| join one) within VEC_TOL x
eps32 / gap (`small_linalg.compare_eigh`). The five-point solver's 4-D
nullspace is one such cluster: any orthonormal basis of it is right, so
candidates are compared as sets, never slot by slot."""

import ast
import hashlib
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.geometry import epipolar as jep
from visualslam_tpu.geometry import ransac as jrs
from visualslam_tpu.geometry.fivepoint import five_point as jax_five_point
from visualslam_tpu.geometry.se3 import exp_so3 as jexp_so3
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.geometry import epipolar as tep
from visualslam_tpu_torch.geometry import ransac as trs
from visualslam_tpu_torch.geometry.fivepoint import MAX_CANDIDATES, five_point
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import KERNELS, PLAIN, reads_host
from visualslam_tpu_torch.ops.cuda import small_linalg as sl
from visualslam_tpu_torch.ops.cuda.triangulate import EPS32, GAP_MIN, VEC_TOL
from visualslam_tpu_torch.slam import tracker as ttr
from visualslam_tpu_torch.slam import two_view as ttv
from visualslam_tpu_torch.utils.config import FAST_CONFIG, SlamConfig
from visualslam_tpu_torch.utils.graphs import ProgramGraph

ROOT = Path(__file__).resolve().parents[1]
# the kernels' arithmetic on the CPU: what the card computes, bit for bit
REPLAY = KERNELS._replace(sym_eigh=sl.sym_eigh_jacobi, svd3=sl.svd3_jacobi)
COUNT_TIE = 3       # hazard 12: a float32 winner within 3 inliers of float64's


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _symmetric(rng, B, n, rank=None):
    """[B, n, n] float32 X X^T, of the given rank (n by default)."""
    X = rng.standard_normal((B, n, rank or n)).astype(np.float32)
    return np.ascontiguousarray(X @ X.transpose(0, 2, 1))


def _scene(rng, n=200, M=256, noise=1e-3, outliers=0.2):
    """[M, 2] normalized correspondences of n points in front of both
    cameras (a share replaced by outliers), the valid mask and (R, t)."""
    R = np.asarray(jexp_so3(jnp.asarray(rng.normal(0, 0.05, 3))), np.float32)
    t = (np.array([0.6, 0.05, 0.1]) + rng.normal(0, 0.02, 3)).astype(
        np.float32)
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
    return a, b, np.arange(M) < n, R, t


def _recording(calls: dict):
    """REPLAY with every sym_eigh / svd3 input kept, per kernel."""
    def rec(name, fn):
        def wrapped(x):
            calls.setdefault(name, []).append(x.clone())
            return fn(x)
        return wrapped

    return REPLAY._replace(sym_eigh=rec("sym_eigh", sl.sym_eigh_jacobi),
                           svd3=rec("svd3", sl.svd3_jacobi))


def _jax_eigh(M):
    w, V = jnp.linalg.eigh(jnp.asarray(np.asarray(M)))
    return np.asarray(w), np.asarray(V)


def _assert_eigh_matches(w, V, wj, Vj):
    r = sl.compare_eigh(w, V, wj, Vj)
    assert r["val_err"] <= sl.EIG_TOL, r
    assert r["compared"] > 0 and r["worst"] <= VEC_TOL, r
    return r


@pytest.mark.parametrize("n", [9, 10])
def test_sym_eigh_replay_matches_jax_eigh_on_random_matrices(rng, n):
    """Random symmetric n x n: eigenvalues within 1e-5 x max |lambda|,
    eigenvectors within VEC_TOL x eps32 / gap (measured ~7 against 32);
    the ascending order and unit eigenvectors of jnp.linalg.eigh."""
    M = torch.from_numpy(_symmetric(rng, 128, n))
    w, V = sl.sym_eigh_jacobi(M)
    assert bool((w[:, 1:] >= w[:, :-1]).all())
    np.testing.assert_allclose(torch.linalg.vector_norm(V, dim=1), 1.0,
                               atol=1e-5)
    _assert_eigh_matches(w, V, *_jax_eigh(M))


# SHA-256 of sym_eigh_jacobi's (w, V) bytes on _pinned_matrices(n),
# recorded before the kernel moved to a lane group per matrix: the replay
# keeps its bits, so a kernel held to it bit for bit keeps them too
REPLAY_DIGESTS = {
    4: "6e70a12d75d7a75ec36dcc347e80c2188b5e7eb56494bd709f6e9f7060d5cc8e",
    9: "cca2db71e1b98d01eb5b19cb426ecb07cb86384bca81462efd77615d4b19eff7",
    10: "ebd310d4b09c1bed67e5e9f3e4ce84f449995d34f36479c45c9d92c93f261d3e",
}


def _pinned_matrices(n, B=32):
    """[B, n, n] float32: sums of outer products of seeded float64 columns,
    added elementwise in a fixed order (no BLAS, so the same bits on any
    CPU) and rounded once; every fourth of rank n - 2."""
    r = np.random.default_rng(1000 + n)
    X = r.standard_normal((B, n, n))
    X[::4, :, n - 2:] = 0.0
    M = np.zeros((B, n, n))
    for k in range(n):
        M += X[:, :, k, None] * X[:, None, :, k]
    return torch.from_numpy(M.astype(np.float32))


@pytest.mark.parametrize("n", sorted(REPLAY_DIGESTS))
def test_sym_eigh_replay_bits_are_pinned(n):
    """sym_eigh_jacobi gives the recorded bits on seeded matrices."""
    w, V = sl.sym_eigh_jacobi(_pinned_matrices(n))
    digest = hashlib.sha256(w.numpy().tobytes() + V.numpy().tobytes())
    assert digest.hexdigest() == REPLAY_DIGESTS[n]


def _pinned_svd3(kind, B=32):
    """[B, 3, 3] float32 from seeded float64 values by elementwise
    operations in a fixed order (no BLAS, no libm beyond the correctly
    rounded sqrt, so the same bits on any CPU), rounded once: "random"
    Gaussian entries; "essential" [t]x R with R from a unit quaternion;
    "tiny" / "huge" essential matrices times 2^-60 / 2^50, whose A^T A
    reaches float32's subnormal and overflow ranges; "rank1" outer
    products."""
    r = np.random.default_rng(2000 + ("random", "essential", "tiny", "huge",
                                      "rank1").index(kind))
    if kind == "random":
        return torch.from_numpy(r.standard_normal((B, 3, 3))
                                .astype(np.float32))
    if kind == "rank1":
        x, y = r.standard_normal((2, B, 3))
        return torch.from_numpy((x[:, :, None] * y[:, None, :])
                                .astype(np.float32))
    q = r.standard_normal((B, 4))
    w, x, y, z = (q / np.sqrt(q[:, 0] * q[:, 0] + q[:, 1] * q[:, 1]
                              + q[:, 2] * q[:, 2] + q[:, 3] * q[:, 3])
                  [:, None]).T
    R = [[1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
         [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
         [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)]]
    t = r.standard_normal((3, B))
    zero = np.zeros(B)
    tx = [[zero, -t[2], t[1]], [t[2], zero, -t[0]], [-t[1], t[0], zero]]
    E = np.stack([np.stack([tx[i][0] * R[0][j] + tx[i][1] * R[1][j]
                            + tx[i][2] * R[2][j] for j in range(3)], -1)
                  for i in range(3)], 1).astype(np.float32)
    scale = {"essential": 1.0, "tiny": 2.0 ** -60, "huge": 2.0 ** 50}[kind]
    return torch.from_numpy(E * np.float32(scale))


# SHA-256 of svd3_jacobi's (U, S, Vh) bytes on _pinned_svd3(kind), recorded
# when the kernel moved to a lane group per matrix: the replay defines the
# kernel's bits (tests/test_torch_gpu.py holds the kernel to it)
SVD3_DIGESTS = {
    "random":
    "5e3537b421a4e5fa2645f8a775332396d7f883e867e9942f75f57cbdca0171e5",
    "essential":
    "97a9dd6595fbb12786569194e6ab16a078d41afe58b9cccf7db8b3f2752a469f",
    "tiny":
    "a45737f504b169025b3c6fd3d540938616d3bef2390f7401401780488b2350e1",
    "huge":
    "46cf8bcbc8b858b76e440d7bfa59e5f42b18b5beb7dea2936ced1fb2d6b89d47",
    "rank1":
    "f53d4f6810140934dd71663de933fa64468dc06d151a8c299069d5aaf5c6fe8f",
}


@pytest.mark.parametrize("kind", sorted(SVD3_DIGESTS))
def test_svd3_replay_bits_are_pinned(kind):
    """svd3_jacobi gives the recorded bits on seeded 3x3 batches."""
    U, S, Vh = sl.svd3_jacobi(_pinned_svd3(kind))
    digest = hashlib.sha256(U.numpy().tobytes() + S.numpy().tobytes()
                            + Vh.numpy().tobytes())
    assert digest.hexdigest() == SVD3_DIGESTS[kind]


def test_small_linalg_replays_converge_within_their_sweeps(rng):
    """The relative off-diagonal norm of every matrix (random 9x9, 10x10
    and 3x3; the 8-point's normal matrices and Fs; the five-point's 9x9 and
    10x10 systems) lies below float32 epsilon before the last sweep:
    EIGH_SWEEPS and SVD_SWEEPS are the counts where it does, plus one."""
    x1, x2, valid, _, _ = _scene(rng, noise=5e-4, outliers=0.0)
    calls = {}
    idx = rng.integers(0, 200, (64, 8))
    tep.eight_point(torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]),
                    None, _recording(calls))
    idx = np.stack([rng.permutation(200)[:5] for _ in range(32)])
    five_point(torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]),
               _recording(calls))
    cases = [(sl.sym_eigh_jacobi, M.reshape(-1, M.shape[-1], M.shape[-1]))
             for M in [torch.from_numpy(_symmetric(rng, 64, 9)),
                       torch.from_numpy(_symmetric(rng, 64, 10))]
             + calls["sym_eigh"]]
    cases += [(sl.svd3_jacobi, A) for A in (
        torch.from_numpy(rng.standard_normal((64, 3, 3)).astype(np.float32)),
        calls["svd3"][0])]
    for replay, M in cases:
        offs = []
        replay(M, offs=offs)
        worst = [float(o.max()) for o in offs]
        assert worst[-2] < EPS32, (tuple(M.shape), worst)


def test_sym_eigh_replay_on_eight_point_normal_matrices(rng):
    """The 9x9 normal matrices of 256 minimal 8-point samples (what RANSAC
    solves) and of the weighted refit, through the replay and
    jnp.linalg.eigh: eigenvalues and gated eigenvectors as above, and the
    smallest eigenvector (the solution) wherever its gap is >= GAP_MIN."""
    x1, x2, valid, _, _ = _scene(rng)
    idx = rng.integers(0, 200, (256, 8))
    calls = {}
    rec = _recording(calls)
    tep.eight_point(torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]),
                    None, rec)
    tep.eight_point(torch.from_numpy(x1), torch.from_numpy(x2),
                    torch.from_numpy(valid.astype(np.float32)), rec)
    for M in calls["sym_eigh"]:
        M = M.reshape(-1, 9, 9)
        w, V = sl.sym_eigh_jacobi(M)
        r = _assert_eigh_matches(w, V, *_jax_eigh(M))
        assert r["compared"] >= len(M)


def _null_vector_errors(V, u):
    """|v - (+-u)| of each unit smallest eigenvector v of V (columns,
    ascending order; normalized in float64) against u [B, n]."""
    v = np.asarray(V, np.float64)[:, :, 0]
    v = v / np.linalg.norm(v, axis=-1, keepdims=True)
    s = np.sign((v * u).sum(-1, keepdims=True))
    return np.linalg.norm(v - s * u, axis=-1)


@pytest.mark.parametrize("seed", [0, 1])
def test_sym_eigh_float64_operations_fix_the_eight_point_solution(seed):
    """Why sym_eigh computes in float64: the 8-point's normal matrices
    M = A^T A of 256 minimal samples (and the refit's) have their smallest
    eigenvalue apart from the next by a relative gap g of ~1 / cond(A)^2
    (down to ~1e-9 here), and a float32 solver fixes that eigenvector, the
    8-point solution, only to ~eps32 / g. Against float64 LAPACK on the
    same float32 matrices: the kernel's arithmetic (float64 operations,
    rounded to float32 once) is within eps32 on every matrix (measured
    0.36 eps32: the output's rounding); jnp.linalg.eigh (float32) and the
    same Jacobi with float32 operations stay within VEC_TOL x eps32 / g,
    the float32 bound (measured 0.6), but their median error is past 100
    x eps32 (measured ~600), and past 0.1 (no solution) where g < 1e-8."""
    rng = np.random.default_rng(seed)
    x1, x2, valid, _, _ = _scene(rng)
    idx = rng.integers(0, 200, (256, 8))
    calls = {}
    rec = _recording(calls)
    tep.eight_point(torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]),
                    None, rec)
    tep.eight_point(torch.from_numpy(x1), torch.from_numpy(x2),
                    torch.from_numpy(valid.astype(np.float32)), rec)
    M = torch.cat([m.reshape(-1, 9, 9) for m in calls["sym_eigh"]])
    m64 = np.tril(M.double().numpy())
    w, U = np.linalg.eigh(m64 + np.tril(m64, -1).transpose(0, 2, 1))
    u = U[:, :, 0]
    g = (w[:, 1] - w[:, 0]) / np.abs(w).max(-1)
    e_kernel = _null_vector_errors(sl.sym_eigh_jacobi(M)[1], u)
    e_f32 = _null_vector_errors(
        sl.sym_eigh_jacobi(M, ops=torch.float32)[1], u)
    e_jax = _null_vector_errors(_jax_eigh(M)[1], u)
    assert e_kernel.max() <= EPS32, e_kernel.max() / EPS32
    for e in (e_f32, e_jax):
        assert (e * g / EPS32).max() <= VEC_TOL
        assert np.median(e) > 100 * EPS32
        assert (g < 1e-8).any() and np.median(e[g < 1e-8]) > 0.1


def test_five_point_nullspace_projector_matches_jax(rng):
    """The five-point solver's 9x9 A^T A (rank 5): the replay's 4-D
    nullspace (its four smallest eigenvectors) against jnp.linalg.eigh's by
    the projector onto it, within VEC_TOL x eps32 / gap (gap: the fifth
    eigenvalue over the largest) wherever that gap is >= GAP_MIN (a sample
    whose five points nearly lose rank has a nullspace float32 does not
    fix, in either package); the basis vectors themselves differ."""
    x1, x2, _, _, _ = _scene(rng, outliers=0.0)
    idx = np.stack([rng.permutation(200)[:5] for _ in range(64)])
    calls = {}
    five_point(torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]),
               _recording(calls))
    M = calls["sym_eigh"][0]
    assert tuple(M.shape) == (64, 9, 9)
    w, V = sl.sym_eigh_jacobi(M)
    wj, Vj = _jax_eigh(M)
    lam = np.linalg.eigvalsh(M.double().numpy())
    gap = (lam[:, 4] - lam[:, 3]) / lam[:, 8]
    gate = gap >= GAP_MIN
    assert gate.mean() >= 0.5
    P = V[:, :, :4].double().numpy()
    Pj = Vj[:, :, :4].astype(np.float64)
    d = np.linalg.norm(P @ P.transpose(0, 2, 1) - Pj @ Pj.transpose(0, 2, 1),
                       2, axis=(1, 2))
    score = (d * gap / EPS32)[gate]
    assert score.max() <= VEC_TOL, score.max()
    # the vectors are not the same basis, only the same space
    assert np.abs(np.abs(P) - np.abs(Pj)).max() > 1e-3


def _essential(rng, B):
    """[B, 3, 3] unit-norm essential matrices [t]x R."""
    out = []
    for _ in range(B):
        R = np.asarray(jexp_so3(jnp.asarray(rng.normal(0, 0.3, 3))))
        t = rng.normal(0, 1, 3)
        E = np.array([[0, -t[2], t[1]], [t[2], 0, -t[0]],
                      [-t[1], t[0], 0]]) @ R
        out.append(E / np.linalg.norm(E))
    return np.stack(out).astype(np.float32)


def test_svd3_replay_matches_jax_svd(rng):
    """Random 3x3 and rank-2 essential matrices: singular values within
    1e-5 x sigma_1, the left and right vectors gated by singular-value gaps
    within VEC_TOL x eps32 / gap, A = U diag(S) Vh, and on the essential
    matrices U[:, 2] (the translation decompose_essential reads) against
    the reference's up to sign."""
    for A in (rng.standard_normal((256, 3, 3)).astype(np.float32),
              _essential(rng, 128)):
        U, S, Vh = sl.svd3_jacobi(torch.from_numpy(A))
        Uj, Sj, Vhj = (np.asarray(x) for x in jnp.linalg.svd(jnp.asarray(A)))
        r = sl.compare_svd3(U, S, Vh, Uj, Sj, Vhj)
        assert r["val_err"] <= sl.EIG_TOL and r["worst"] <= VEC_TOL, r
        rec = (U * S[:, None, :]) @ Vh
        np.testing.assert_allclose(rec.numpy(), A, atol=2e-6 * np.abs(A).max())
    gap = (Sj[:, 1] - Sj[:, 2]) / Sj[:, 0]
    assert gap.min() >= GAP_MIN
    u3, u3j = U[:, :, 2].double().numpy(), Uj[:, :, 2].astype(np.float64)
    d = np.minimum(np.linalg.norm(u3 - u3j, axis=1),
                   np.linalg.norm(u3 + u3j, axis=1))
    assert (d * gap / EPS32).max() <= VEC_TOL


def _up_to_sign(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    return a if np.abs(a - b).sum() <= np.abs(a + b).sum() else -a, b


def test_eight_point_with_replay_kernels_matches_jax(rng):
    """tests/test_torch_two_view.py's 8-point case with the card's
    arithmetic: the weighted solve within 1e-4 of the float64 solve and
    5e-4 of the reference, each minimal solve within 0.05 of float64."""
    x1, x2, _, _, _ = _scene(rng, n=60, M=60, outliers=0.0)
    w = (rng.random(60) > 0.1).astype(np.float32)
    Et = tep.eight_point(torch.tensor(x1), torch.tensor(x2), torch.tensor(w),
                         REPLAY).numpy()
    E64 = tep.eight_point(torch.tensor(x1).double(),
                          torch.tensor(x2).double(),
                          torch.tensor(w).double()).numpy()
    Ej = np.asarray(jep.eight_point(jnp.asarray(x1), jnp.asarray(x2),
                                    jnp.asarray(w)))
    np.testing.assert_allclose(*_up_to_sign(Et, E64), atol=1e-4)
    np.testing.assert_allclose(*_up_to_sign(Et, Ej), atol=5e-4)
    x8 = torch.tensor(x1[:24]).reshape(3, 8, 2)
    y8 = torch.tensor(x2[:24]).reshape(3, 8, 2)
    Eb = tep.eight_point(x8, y8, None, REPLAY).numpy()
    for k in range(3):
        e64 = tep.eight_point(x8[k].double(), y8[k].double()).numpy()
        np.testing.assert_allclose(*_up_to_sign(Eb[k], e64), atol=0.05)


def test_five_point_replay_candidate_sets_match_jax(rng):
    """tests/test_torch_fivepoint.py's candidate-set case with the card's
    arithmetic: on 64 noise-free samples each package finds the true E
    (Sampson < 1e-6 on >= 95% of the scene) in >= 70% of them, within 10%
    of each other, and agrees with the reference up to sign within 3e-2
    where both find it."""
    R = np.asarray(jexp_so3(jnp.asarray(rng.normal(0, 0.2, 3))), np.float64)
    t = rng.normal(0, 1, 3)
    t /= np.linalg.norm(t)
    X = rng.uniform([-2, -2, 4], [2, 2, 10], (200, 3))
    x1 = (X[:, :2] / X[:, 2:]).astype(np.float32)
    X2 = X @ R.T + t
    x2 = (X2[:, :2] / X2[:, 2:]).astype(np.float32)
    idx = np.stack([rng.permutation(200)[:5] for _ in range(64)])
    Ej, vj = (np.asarray(a) for a in jax.jit(jax.vmap(jax_five_point))(
        jnp.asarray(x1[idx]), jnp.asarray(x2[idx])))
    Et, vt = five_point(torch.from_numpy(x1[idx]), torch.from_numpy(x2[idx]),
                        REPLAY)
    assert tuple(Et.shape) == (64, MAX_CANDIDATES, 3, 3)
    Et, vt = Et.numpy(), vt.numpy()

    def explains(E):
        err = tep.sampson_error(torch.from_numpy(E.reshape(-1, 3, 3).copy()),
                                torch.from_numpy(x1), torch.from_numpy(x2))
        return ((err < 1e-6).float().mean(-1) >= 0.95).numpy().reshape(
            E.shape[:2])

    sj, st = explains(Ej) & vj, explains(Et) & vt
    assert sj.any(1).mean() >= 0.7 and st.any(1).mean() >= 0.7
    assert abs(sj.any(1).mean() - st.any(1).mean()) <= 0.1
    for k in np.nonzero(sj.any(1) & st.any(1))[0]:
        a, b = Et[k][st[k]][0], Ej[k][sj[k]][0]
        assert min(np.abs(a - b).max(), np.abs(a + b).max()) < 3e-2


def _replay(key, valid, N, n):
    keys = jax.random.split(key, N)
    return np.array(jax.vmap(
        lambda k: jrs._gumbel_sample_indices(k, jnp.asarray(valid), n))(keys))


@pytest.fixture()
def replayed(monkeypatch):
    """Point the port's sampler at a queue of replayed draws."""
    queue = []

    def sample(gen, valid, N, n):
        return torch.as_tensor(queue.pop(0), device=valid.device)

    monkeypatch.setattr(trs, "sample_indices", sample)
    return queue


def _counts(x1, x2, valid, idx, thr, kernels, dtype):
    """Per-hypothesis inlier counts of the 8-point samples idx."""
    a, b = (torch.from_numpy(x).to(dtype) for x in (x1, x2))
    Es = tep.eight_point(a[idx], b[idx], None, kernels)
    inl = (tep.sampson_error(Es, a, b) < thr) & torch.from_numpy(valid)
    return inl.sum(-1).numpy()


def _rot_deg(Ra, Rb):
    c = (np.trace(np.asarray(Ra) @ np.asarray(Rb).T) - 1) / 2
    return float(np.degrees(np.arccos(np.clip(c, -1, 1))))


@pytest.mark.parametrize("seed", [0, 1])
def test_eight_point_ransac_with_replay_kernels_in_hazard_12_band(
        replayed, seed):
    """The reference's 8-point draws replayed into the port with the card's
    arithmetic: the float32 winner within COUNT_TIE inliers of the float64
    maximum over the same hypotheses, and the recovered rotation within
    0.1 deg of the reference's (test_torch_two_view.py's bound)."""
    rng = np.random.default_rng(seed)
    x1, x2, valid, _, _ = _scene(rng)
    rc = jcfg.RansacConfig(num_hypotheses=128, inlier_threshold=5e-5)
    cfg = SlamConfig.from_json(jcfg.SlamConfig(ransac=rc).to_json()).ransac
    key = jax.random.PRNGKey(seed)
    idx = _replay(key, valid, rc.num_hypotheses, rc.sample_size)
    c32 = _counts(x1, x2, valid, idx, rc.inlier_threshold, REPLAY,
                  torch.float32)
    c64 = _counts(x1, x2, valid, idx, rc.inlier_threshold, PLAIN,
                  torch.float64)
    assert c64[int(np.argmax(c32))] >= c64.max() - COUNT_TIE
    replayed.append(idx)
    Rt, _, _, mt, nt = trs.estimate_relative_pose(
        torch.from_numpy(x1), torch.from_numpy(x2), torch.from_numpy(valid),
        cfg, None, REPLAY)
    Rj, _, _, mj, nj = jrs.estimate_relative_pose(
        jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid), rc, key)
    assert _rot_deg(Rt.numpy(), Rj) < 0.1
    assert abs(int(nt) - int(nj)) <= COUNT_TIE + 0.03 * int(nj)


@pytest.mark.parametrize("seed", [0, 1])
def test_five_point_ransac_with_replay_kernels_in_band(replayed, seed):
    """The reference's five-point draws replayed with the card's arithmetic:
    tests/test_torch_fivepoint.py's band (inlier counts within 3% + 2, masks
    apart on at most 3% of the points) and the rotation within 0.5 deg of
    the truth (chip_smoke.py's FIVE_POINT_ROT_DEG)."""
    rng = np.random.default_rng(100 + seed)
    x1, x2, valid, R, _ = _scene(rng, outliers=0.3, noise=5e-4)
    rc = jcfg.RansacConfig(num_hypotheses=64, solver="5pt",
                           inlier_threshold=1e-5)
    cfg = SlamConfig.from_json(jcfg.SlamConfig(ransac=rc).to_json()).ransac
    key = jax.random.PRNGKey(seed)
    _, inlj, nj = jrs.ransac_essential(jnp.asarray(x1), jnp.asarray(x2),
                                       jnp.asarray(valid), rc, key)
    replayed.append(_replay(key, valid, 64, 5))
    replayed.append(_replay(key, valid, 64, 5))
    args = (torch.from_numpy(x1), torch.from_numpy(x2),
            torch.from_numpy(valid), cfg, None, REPLAY)
    _, inlt, nt = trs.ransac_essential(*args)
    inlj, inlt = np.asarray(inlj), inlt.numpy()
    assert abs(int(nt) - int(nj)) <= 0.03 * int(nj) + 2
    assert (inlt != inlj).mean() <= 0.03
    Rt = trs.estimate_relative_pose(*args)[0]
    assert _rot_deg(Rt.numpy(), R) < 0.5


def _features(rng, n=300, cap=384):
    """Two views' injected features of one point cloud (64-D descriptors),
    the intrinsics."""
    R = np.asarray(jexp_so3(jnp.asarray(rng.normal(0, 0.05, 3))))
    t = np.array([0.6, 0.05, 0.1])
    X = rng.uniform([-6, -4, 8], [6, 4, 30], (n, 3))
    desc = rng.standard_normal((n, 64)).astype(np.float32)
    intr = np.array([400.0, 400.0, 320.0, 240.0], np.float32)
    out = []
    for k, (Rk, tk) in enumerate(((np.eye(3), np.zeros(3)), (R, t))):
        Xc = X @ Rk.T + tk
        px = Xc[:, :2] / Xc[:, 2:] * intr[:2] + intr[2:]
        yx = np.zeros((cap, 2), np.float32)
        yx[:n] = (px + rng.normal(0, 0.3, px.shape))[:, ::-1]
        d = np.zeros((cap, 64), np.float32)
        d[:n] = desc + k * rng.normal(0, 0.05, desc.shape)
        out.append(Features(Keypoints.empty(cap)._replace(
            yx=torch.tensor(yx), valid=torch.tensor(np.arange(cap) < n)),
            torch.tensor(d)))
    return out, torch.tensor(intr)


def _equal(a, b) -> bool:
    la, lb = (jax.tree_util.tree_leaves(x) for x in (a, b))
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


@pytest.mark.parametrize("solver", ["8pt", "5pt"])
def test_programs_equal_their_eager_functions_on_the_cpu(rng, solver):
    """On the CPU the "ransac" program and two_view_from_features_jit are
    the eager functions, and the graph program's data flow run uncaptured
    (ProgramGraph(graphs=False), a generator of its own seeded per run)
    equals them bit for bit, for two seeds in turn and the first again."""
    (fa, fb), intr = _features(rng)
    cfg = FAST_CONFIG.replace(ransac=FAST_CONFIG.ransac.replace(
        solver=solver, num_hypotheses=32 if solver == "5pt" else 64))
    prog = ttr._shared_programs(cfg)["ransac"]
    assert prog is ttr._shared_programs(cfg)["ransac"]
    m = ttv.match_features(fa, fb, cfg.match)
    x1 = torch.randn(m.valid.shape[0], 2, generator=torch.Generator()
                     .manual_seed(1)) * 0.3
    x2 = x1 + 0.01 * torch.randn(x1.shape, generator=torch.Generator()
                                 .manual_seed(2))
    x = (x1, x2, m.valid)
    rcfg = (cfg.ransac, KERNELS)
    uncaptured = ProgramGraph(prog, x, rcfg, graphs=False)
    for seed in (5, 6, 5):
        want = trs.estimate_relative_pose(*x, cfg.ransac,
                                          trs.generator(seed, "cpu"))
        assert _equal(prog(x, rcfg, seed), want)
        assert _equal(uncaptured.run(x, seed), want)
        got = ttv.two_view_from_features_jit(fa, fb, intr, cfg, seed)
        assert _equal(got, ttv.two_view_from_features(
            fa, fb, intr, cfg, trs.generator(seed, "cpu")))
    assert not prog.captured
    with pytest.raises(TypeError):
        prog(x, rcfg)


def test_tracker_two_view_solve_reads_back_one_buffer(rng):
    """Tracker._two_view_solve: the program's results and the match come
    back as one packed buffer whose fields equal the eager function's."""
    (fa, fb), intr = _features(rng)
    cfg = FAST_CONFIG.replace(match=FAST_CONFIG.match.replace(
        max_matches=256), ransac=FAST_CONFIG.ransac.replace(
        num_hypotheses=64))
    tr = ttr.Tracker(cfg, intr.numpy(), device="cpu")
    seed = int(torch.randint(0, 2 ** 62, (1,), generator=torch.Generator()
                             .manual_seed(cfg.ransac.seed)))
    tv = tr._two_view_solve(fa, fb)
    m = ttv.match_features(fa, fb, cfg.match)
    want = ttv.two_view_from_features(fa, fb, intr, cfg,
                                      trs.generator(seed, "cpu"))
    assert tv.n == int(want.num_inliers) > 100
    assert tv.n_match == int(m.count())
    np.testing.assert_array_equal(tv.R, want.R.numpy())
    np.testing.assert_array_equal(tv.t, want.t.numpy())
    np.testing.assert_array_equal(tv.X, want.points.numpy())
    np.testing.assert_array_equal(tv.inl, want.inliers.numpy())
    np.testing.assert_array_equal(tv.idx_a, m.idx_a.numpy())
    np.testing.assert_array_equal(tv.idx_b, m.idx_b.numpy())
    assert not reads_host(KERNELS) and reads_host(PLAIN)


# the JAX package's re-exported `*_jit` programs the port has not ported
# yet (ROADMAP A.2-A.3): the list shrinks as they land
QUEUED_JIT = {"build_pyramid_jit", "detect_harris_jit",
              "detect_and_describe_sift_jit", "detect_and_describe_orb_jit",
              "match_features_jit"}
SUBPACKAGES = ("models", "slam", "backend", "geometry", "ops", "io", "utils")


def _reexports(path: Path) -> list:
    tree = ast.parse(path.read_text())
    return [a.asname or a.name for node in tree.body
            if isinstance(node, ast.ImportFrom) for a in node.names]


def test_package_surface_matches_the_jax_package():
    """Every name the JAX package's subpackages (and its top level)
    re-export is found in the port's counterpart, but the queued programs;
    a fresh import of them pulls in neither jax nor the JAX package."""
    names = {sub: _reexports(ROOT / "visualslam_tpu" / sub / "__init__.py")
             for sub in SUBPACKAGES}
    names[""] = _reexports(ROOT / "visualslam_tpu" / "__init__.py")
    assert "two_view_reconstruction_jit" in names["slam"]
    assert "run_ba_jit" in names["backend"]
    # a name may reach its function through a submodule of the same name
    # (`ops.gradients`, which callers import as a module)
    code = ("import importlib, sys, json, types\n"
            f"names = {names!r}\n"
            "def found(s, n):\n"
            "    m = importlib.import_module(\n"
            "        'visualslam_tpu_torch' + ('.' + s if s else ''))\n"
            "    x = getattr(m, n, None)\n"
            "    return x is not None and (not isinstance(\n"
            "        x, types.ModuleType) or n == 'se3' or hasattr(x, n))\n"
            "missing = [(s, n) for s, ns in names.items() for n in ns\n"
            "           if not found(s, n)]\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in\n"
            "       ('jax', 'visualslam_tpu')]\n"
            "print(json.dumps([missing, bad]))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120, cwd=ROOT)
    import json

    missing, bad = json.loads(out.stdout.strip().splitlines()[-1])
    assert {n for _, n in missing} == QUEUED_JIT, missing
    assert bad == []

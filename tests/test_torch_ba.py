"""The port's window BA (solver schur_dense) against the JAX package, on the
synthetic problems of tests/test_ba.py fed to both."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_ba import make_ba_problem
from visualslam_tpu.backend import ba as jba
from visualslam_tpu.utils.config import BAConfig as JBAConfig
from visualslam_tpu_torch.backend import ba as tba
from visualslam_tpu_torch.utils.config import BAConfig
from visualslam_tpu_torch.utils.convert import from_numpy


def _pad(p, nc=1, nl=8, no=16):
    """The problem padded as the tracker pads a window: invalid identity
    cameras, zero landmarks and observations past the valid ones."""
    a = jax.tree_util.tree_map(np.asarray, p)
    cat = np.concatenate
    return jba.BAProblem(
        R=cat([a.R, np.tile(np.eye(3, dtype=np.float32), (nc, 1, 1))]),
        t=cat([a.t, np.zeros((nc, 3), np.float32)]),
        X=cat([a.X, np.zeros((nl, 3), np.float32)]),
        cam_idx=cat([a.cam_idx, np.zeros(no, np.int32)]),
        lm_idx=cat([a.lm_idx, np.zeros(no, np.int32)]),
        uv=cat([a.uv, np.zeros((no, 2), np.float32)]),
        obs_valid=cat([a.obs_valid, np.zeros(no, bool)]),
        cam_valid=cat([a.cam_valid, np.zeros(nc, bool)]),
        lm_valid=cat([a.lm_valid, np.zeros(nl, bool)]))


def _problems(rng, pad=False, **kw):
    jp, R_gt, t_gt, X_gt = make_ba_problem(rng, **kw)
    if pad:
        jp = jax.tree_util.tree_map(jnp.asarray, _pad(jp))
    tp = from_numpy(tba.BAProblem, jax.tree_util.tree_map(np.asarray, jp),
                    device="cpu")
    return jp, tp, (R_gt, t_gt, X_gt)


def test_from_numpy_keeps_fields_and_dtypes(rng):
    jp, tp, _ = _problems(rng, n_cams=3, n_lms=20)
    for name in tba.BAProblem._fields:
        want = np.asarray(getattr(jp, name))
        got = getattr(tp, name).numpy()
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want)


def test_inv3x3_matches_jax(rng):
    M = rng.standard_normal((50, 3, 3)).astype(np.float32)
    M = M @ M.transpose(0, 2, 1) + 0.1 * np.eye(3, dtype=np.float32)
    M[0] = 0.0                                   # singular: det clamped
    got = tba._inv3x3(torch.from_numpy(M)).numpy()
    want = np.asarray(jba._inv3x3(jnp.asarray(M)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got[1:] @ M[1:],
                               np.broadcast_to(np.eye(3), (49, 3, 3)),
                               atol=1e-3)


def test_normal_equations_match_jax(rng):
    jp, tp, _ = _problems(rng, n_cams=4, n_lms=60)
    cfg = BAConfig()
    got = tba.normal_equations(tp, tp.R, tp.t, tp.X, cfg)
    want = jba.normal_equations(jp, jp.R, jp.t, jp.X, JBAConfig())
    for name, g, w in zip(("U", "V", "bc", "bl", "Wd"), got, want):
        w = np.asarray(w)
        assert g.shape == w.shape, name
        # float32 sums of per-observation products in another order
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * (1 + np.abs(w).max()),
                                   err_msg=name)
    lam = 1e-3
    S, b, Vinv = tba.schur_camera_system(*got, lam)
    jS, jb, jVinv = jba.schur_camera_system(*want, lam)
    np.testing.assert_allclose(S.numpy(), np.asarray(jS), rtol=1e-3,
                               atol=1e-3 * np.abs(np.asarray(jS)).max())
    dc = tba.solve_cameras(S, b, tp.cam_valid, lam, cfg)
    jdc = jba.solve_cameras(jS, jb, jp.cam_valid, lam, JBAConfig())
    np.testing.assert_allclose(dc.numpy(), np.asarray(jdc), rtol=1e-3,
                               atol=1e-4)
    np.testing.assert_array_equal(dc[0].numpy(), 0.0)     # gauge camera
    dl = tba.backsub_landmarks(Vinv, got[3], got[4], dc, tp.lm_valid)
    jdl = jba.backsub_landmarks(jVinv, want[3], want[4], jdc, jp.lm_valid)
    np.testing.assert_allclose(dl.numpy(), np.asarray(jdl), rtol=1e-3,
                               atol=1e-4)


def test_robust_cost_matches_jax(rng):
    jp, tp, _ = _problems(rng, n_cams=3, n_lms=40, pix_noise=2e-3)
    for delta in (5e-3, 1e-3):
        got = tba.robust_cost(tp, tp.R, tp.t, tp.X, delta).item()
        want = float(jba.robust_cost(jp, jp.R, jp.t, jp.X, delta))
        assert got == pytest.approx(want, rel=1e-5)


@pytest.mark.parametrize("pix_noise", [0.0, 1e-3])
def test_run_ba_matches_jax(rng, pix_noise):
    jp, tp, (R_gt, t_gt, X_gt) = _problems(rng, pad=True, n_cams=6,
                                           n_lms=200, pix_noise=pix_noise)
    res = tba.run_ba(tp, BAConfig(iters=10))
    want = jax.jit(jba.run_ba, static_argnums=1)(jp, JBAConfig(iters=10))
    assert res.cost.item() < 0.1 * res.initial_cost.item()
    assert res.initial_cost.item() == pytest.approx(
        float(want.initial_cost), rel=1e-5)
    # float32 sums in another order: once the cost has converged, an
    # accept (new_cost < cost) can flip on a near-tie and the damping paths
    # part, so hold cost and state to tolerances, not lambda or bits
    assert res.cost.item() == pytest.approx(float(want.cost), rel=1e-2,
                                            abs=1e-9)
    np.testing.assert_allclose(res.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(want.t), atol=1e-3)
    np.testing.assert_allclose(res.X.numpy(), np.asarray(want.X), atol=1e-2)
    # the padding stays as it was
    np.testing.assert_array_equal(res.R[-1].numpy(), np.eye(3))
    np.testing.assert_array_equal(res.X[-8:].numpy(), 0.0)


def test_run_ba_packed_round_trip(rng):
    _, tp, _ = _problems(rng, n_cams=3, n_lms=30)
    cfg = BAConfig(iters=3)
    res = tba.run_ba(tp, cfg)
    R, t, X, cost, init = tba.unpack_ba_result(tba.run_ba_packed(tp, cfg),
                                               3, 30)
    np.testing.assert_array_equal(R, res.R.numpy())
    np.testing.assert_array_equal(t, res.t.numpy())
    np.testing.assert_array_equal(X, res.X.numpy())
    assert (cost, init) == (res.cost.item(), res.initial_cost.item())


def test_singular_step_is_rejected(rng):
    """A singular reduced system gives NaN increments (solve_ex reports
    it instead of raising), and the LM keeps the state, as the JAX
    package's non-finite solve does."""
    _, tp, _ = _problems(rng, n_cams=3, n_lms=30)
    p = tp._replace(obs_valid=torch.zeros_like(tp.obs_valid))
    S = torch.zeros(3, 6, 3, 6)
    dc = tba.solve_cameras(S, torch.ones(3, 6), torch.ones(3, dtype=torch.bool),
                           0.0, BAConfig())
    assert torch.isnan(dc).all()
    res = tba.run_ba(p, BAConfig(iters=2, damping_init=0.0))
    assert torch.equal(res.R, p.R) and torch.equal(res.X, p.X)


SOLVERS = ["schur_cg", "schur_mf"]


@pytest.mark.parametrize("solver", SOLVERS)
@pytest.mark.parametrize("pix_noise", [0.0, 1e-3])
def test_run_ba_cg_solvers_match_jax(rng, solver, pix_noise):
    """run_ba under the two CG solvers against the JAX package's run_ba
    under the same solver, on the padded window problem."""
    jp, tp, _ = _problems(rng, pad=True, n_cams=6, n_lms=200,
                          pix_noise=pix_noise)
    res = tba.run_ba(tp, BAConfig(iters=10, solver=solver))
    want = jax.jit(jba.run_ba, static_argnums=1)(
        jp, JBAConfig(iters=10, solver=solver))
    assert res.cost.item() < 0.1 * res.initial_cost.item()
    assert res.initial_cost.item() == pytest.approx(
        float(want.initial_cost), rel=1e-5)
    # as the dense case: float32 sums in another order, so the cost within
    # 1e-2 relative and the state within the dense case's tolerances
    assert res.cost.item() == pytest.approx(float(want.cost), rel=1e-2,
                                            abs=1e-9)
    np.testing.assert_allclose(res.R.numpy(), np.asarray(want.R), atol=1e-4)
    np.testing.assert_allclose(res.t.numpy(), np.asarray(want.t), atol=1e-3)
    np.testing.assert_allclose(res.X.numpy(), np.asarray(want.X), atol=1e-2)
    np.testing.assert_array_equal(res.R[-1].numpy(), np.eye(3))
    np.testing.assert_array_equal(res.X[-8:].numpy(), 0.0)


@pytest.mark.parametrize("solver", SOLVERS)
def test_lm_step_cg_solvers_match_dense_step(rng, solver):
    """One LM step under a CG solver equals the dense step (same linear
    system, another solve) to CG tolerance, as tests/test_ba.py holds the
    JAX package's schur_mf; and equals the JAX package's step under the
    same solver within 1e-4."""
    jp, tp, _ = _problems(rng, n_cams=4, n_lms=120)
    lam = 1e-3
    dense = tba.ba_step(tp, tp.R, tp.t, tp.X, torch.tensor(lam),
                        BAConfig(iters=1))
    got = tba.ba_step(tp, tp.R, tp.t, tp.X, torch.tensor(lam),
                      BAConfig(iters=1, solver=solver, cg_iters=200))
    want = jba.ba_step(jp, jp.R, jp.t, jp.X, jnp.asarray(lam),
                       JBAConfig(iters=1, solver=solver, cg_iters=200))
    for a, b, w in zip(dense, got, want):
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=3e-4)
        np.testing.assert_allclose(b.numpy(), np.asarray(w), atol=1e-4)


def test_schur_matvec_mf_is_the_dense_reduced_system(rng):
    """The matrix-free product equals the damped, gauge-fixed dense reduced
    system S2 @ v (frozen cameras act as identity), and the mf factors
    equal the JAX package's."""
    jp, tp, _ = _problems(rng, pad=True, n_cams=5, n_lms=80)
    cfg = BAConfig()
    lam = 1e-2
    U, V, bc, bl, Wd = tba.normal_equations(tp, tp.R, tp.t, tp.X, cfg)
    Um, Vm, bcm, blm, Wo = tba.normal_equations_mf(tp, tp.R, tp.t, tp.X, cfg)
    want = jba.normal_equations_mf(jp, jp.R, jp.t, jp.X, JBAConfig())
    for name, g, w in zip(("U", "V", "bc", "bl", "Wo"),
                          (Um, Vm, bcm, blm, Wo), want):
        w = np.asarray(w)
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4,
                                   atol=1e-4 * (1 + np.abs(w).max()),
                                   err_msg=name)
    S, _, V_inv = tba.schur_camera_system(U, V, bc, bl, Wd, lam)
    C = U.shape[0]
    frozen = ~tp.cam_valid | (torch.arange(C) == 0)
    free6 = (~frozen).float()[:, None].expand(C, 6)
    mask6 = free6.reshape(-1)
    S2 = (S.reshape(6 * C, 6 * C) + lam * torch.eye(6 * C)) \
        * mask6[:, None] * mask6[None, :] + torch.diag(1.0 - mask6)
    v = torch.from_numpy(rng.standard_normal((C, 6)).astype(np.float32))
    got = tba.schur_matvec_mf(v, Um, V_inv, Wo, tp.cam_idx.long(),
                              tp.lm_idx.long(), lam, free6)
    ref = (S2 @ v.reshape(-1)).reshape(C, 6)
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-4,
                               atol=1e-4 * ref.abs().max().item())


def _spd(rng, n, eigs):
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    return (Q * np.asarray(eigs)) @ Q.T


def test_cg_matches_jax_and_stops_early(rng):
    """`cg` against jax.scipy.sparse.linalg.cg on an SPD system with three
    distinct eigenvalues: CG converges in 3 iterations, after which a loop
    without the stop test divides 0 by 0; with it the result stays the
    converged one, as JAX's (within 1e-5)."""
    import jax.scipy.sparse.linalg as jsl

    A = _spd(rng, 12, [1.0] * 4 + [3.0] * 4 + [10.0] * 4).astype(np.float32)
    b = rng.standard_normal(12).astype(np.float32)
    d = 1.0 / np.diag(A)
    want, _ = jsl.cg(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                     M=lambda v: jnp.asarray(d) * v, maxiter=50, tol=1e-10)
    At, dt = torch.from_numpy(A), torch.from_numpy(d)
    got = tba.cg(lambda v: At @ v, torch.from_numpy(b), lambda v: dt * v, 50)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)
    np.testing.assert_allclose(A @ got.numpy(), b, atol=1e-4)
    # a plain loop of 50 iterations with no stop test gives NaN here
    x = torch.zeros(12)
    r = torch.from_numpy(b)
    p = dt * r
    g = (r * p).sum()
    for _ in range(50):
        Ap = At @ p
        a = g / (p * Ap).sum()
        x, r = x + a * p, r - a * Ap
        z = dt * r
        g2 = (r * z).sum()
        p, g = z + g2 / g * p, g2
    assert not torch.isfinite(x).all()


def test_cg_zero_rhs_gives_zeros(rng):
    """b = 0 stops at k = 0 and returns zeros, as JAX's cg; so does a BA
    step whose free cameras have no observations (every right-hand side 0)
    under both CG solvers."""
    import jax.scipy.sparse.linalg as jsl

    A = torch.from_numpy(_spd(rng, 6, [1, 2, 3, 4, 5, 6]).astype(np.float32))
    got = tba.cg(lambda v: A @ v, torch.zeros(6), lambda v: v, 32)
    want, _ = jsl.cg(lambda v: jnp.asarray(A.numpy()) @ v, jnp.zeros(6),
                     maxiter=32, tol=1e-10)
    np.testing.assert_array_equal(np.asarray(want), 0.0)
    np.testing.assert_array_equal(got.numpy(), 0.0)

    _, tp, _ = _problems(rng, n_cams=3, n_lms=30)
    p = tp._replace(obs_valid=tp.obs_valid & (tp.cam_idx == 0))
    for solver in SOLVERS:
        R, t, X = tba.ba_step(p, p.R, p.t, p.X, torch.tensor(1e-3),
                              BAConfig(solver=solver))
        assert torch.isfinite(R).all() and torch.isfinite(X).all(), solver
        np.testing.assert_array_equal(t[1:].numpy(), p.t[1:].numpy())


@pytest.mark.parametrize("solver", SOLVERS)
def test_run_ba_packed_round_trip_cg_solvers(rng, solver):
    _, tp, _ = _problems(rng, n_cams=3, n_lms=30)
    cfg = BAConfig(iters=3, solver=solver)
    res = tba.run_ba(tp, cfg)
    R, t, X, cost, init = tba.unpack_ba_result(tba.run_ba_packed(tp, cfg),
                                               3, 30)
    np.testing.assert_array_equal(R, res.R.numpy())
    np.testing.assert_array_equal(t, res.t.numpy())
    np.testing.assert_array_equal(X, res.X.numpy())
    assert (cost, init) == (res.cost.item(), res.initial_cost.item())
    assert cost < init

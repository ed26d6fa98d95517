"""Sim(3) and the pose graphs in both packages on the same inputs: sim3
exp / log / compose / inverse (theta -> 0 and s -> 1 included), the SE(3)
and Sim(3) edge costs and autodiff edge Jacobians, and optimize_pose_graph
/ optimize_sim3_graph with the dense and the CG solver on a graph padded to
256 nodes with a loop edge, as LoopCloser.optimize pads it (the padded
graph is the default path: 256 > cg_threshold = 192 selects CG)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.backend import pose_graph as jpg
from visualslam_tpu.geometry import se3 as jse3
from visualslam_tpu.geometry import sim3 as jsim3
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.backend import pose_graph as tpg
from visualslam_tpu_torch.geometry import sim3 as tsim3
from visualslam_tpu_torch.utils.config import PoseGraphConfig

N_PAD, E_PAD = 256, 1024

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _tangents(rng, n=64):
    xi = rng.normal(0, 0.4, (n, 7)).astype(np.float32)
    xi[:8, :3] *= 1e-5          # theta -> 0
    xi[8:16, 6] *= 1e-5         # s -> 1
    xi[16:20, :3] = 0.0         # theta = 0 exactly
    xi[20:24, 6] = 0.0          # s = 1 exactly
    xi[24:26] = 0.0             # identity
    return xi


def test_sim3_group_ops_match_jax(rng):
    xi = _tangents(rng)
    Rj, tj, sj = (np.asarray(v) for v in jsim3.sim3_exp(jnp.asarray(xi)))
    Rt, tt, st = (v.numpy() for v in tsim3.sim3_exp(torch.tensor(xi)))
    # the same closed forms in float32: 1e-5 on unit-scale values
    np.testing.assert_allclose(Rt, Rj, atol=1e-5)
    np.testing.assert_allclose(tt, tj, atol=1e-5)
    np.testing.assert_allclose(st, sj, rtol=1e-6)
    lj = np.asarray(jsim3.sim3_log(jnp.asarray(Rj), jnp.asarray(tj),
                                   jnp.asarray(sj)))
    lt = tsim3.sim3_log(torch.tensor(Rj), torch.tensor(tj),
                        torch.tensor(sj)).numpy()
    # log inverts W by a closed-form inverse where the reference solves:
    # 1e-4 (the round trip itself is held below)
    np.testing.assert_allclose(lt, lj, atol=1e-4)
    np.testing.assert_allclose(lt, xi, atol=1e-4)
    a = [torch.tensor(v) for v in (Rt, tt, st)]
    b = [torch.tensor(v).roll(1, 0) for v in (Rt, tt, st)]
    cj = jsim3.compose(*(jnp.asarray(v.numpy()) for v in a + b))
    ct = tsim3.compose(*a, *b)
    for x, y in zip(ct, cj):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), atol=1e-5)
    ij = jsim3.inverse(*(jnp.asarray(v.numpy()) for v in a))
    it = tsim3.inverse(*a)
    for x, y in zip(it, ij):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=1e-5,
                                   atol=1e-5)
    # S . S^-1 = identity
    Ri, ti, si = tsim3.compose(*a, *it)
    np.testing.assert_allclose(Ri.numpy(), np.tile(np.eye(3), (64, 1, 1)),
                               atol=1e-5)
    np.testing.assert_allclose(ti.numpy(), 0.0, atol=1e-4)
    np.testing.assert_allclose(si.numpy(), 1.0, rtol=1e-6)
    X = rng.normal(0, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        tsim3.transform(*a, torch.tensor(X)).numpy(),
        np.asarray(jsim3.transform(*(jnp.asarray(v.numpy()) for v in a),
                                   jnp.asarray(X))), atol=1e-5)


def trajectory(rng, n=40, noise=0.02):
    """A loop of n world-to-camera poses (ground truth) and odometry that
    drifts: relative poses with noise, chained from node 0."""
    ang = np.linspace(0, 2 * np.pi * (n - 1) / n, n)
    R_gt, t_gt = [], []
    for a in ang:
        w = jnp.asarray([0.0, -a, 0.0], jnp.float32)
        R = np.asarray(jse3.exp_so3(w))
        c = np.array([10 * np.sin(a), 0.0, 10 * np.cos(a) - 10])
        R_gt.append(R)
        t_gt.append(-R @ c)
    R_gt = np.asarray(R_gt, np.float32)
    t_gt = np.asarray(t_gt, np.float32)
    R, t = [R_gt[0]], [t_gt[0]]
    for k in range(1, n):
        Rr = R_gt[k - 1].T @ R_gt[k]
        tr = R_gt[k - 1].T @ (t_gt[k] - t_gt[k - 1])
        dR = np.asarray(jse3.exp_so3(jnp.asarray(rng.normal(0, noise, 3),
                                                 jnp.float32)))
        Rr = dR @ Rr
        tr = tr + rng.normal(0, noise, 3)
        R.append(R[-1] @ Rr)
        t.append(R[-1] @ tr + t[-1])
    return (np.asarray(R, np.float32), np.asarray(t, np.float32), R_gt,
            t_gt)


def graph_arrays(rng, sim3=False):
    """Odometry edges of a drifting loop + one loop edge (last -> first,
    ground-truth relative pose), padded to N_PAD nodes and E_PAD edges as
    LoopCloser.optimize pads them. Returns a dict of numpy arrays."""
    R0, t0, R_gt, t_gt = trajectory(rng)
    n = len(R0)
    ii = list(range(n - 1)) + [0]
    jj = list(range(1, n)) + [n - 1]
    Rm, tm = [], []
    for k in range(n - 1):
        Rm.append(R0[k].T @ R0[k + 1])
        tm.append(R0[k].T @ (t0[k + 1] - t0[k]))
    Rm.append(R_gt[0].T @ R_gt[n - 1])
    tm.append(R_gt[0].T @ (t_gt[n - 1] - t_gt[0]))
    w = [1.0] * (n - 1) + [0.5 * 4.0]
    ne = len(ii)

    def pad(a, target, tail):
        out = np.zeros((target,) + tail, np.float32)
        out[:len(a)] = np.asarray(a)
        return out

    eyeN = np.tile(np.eye(3, dtype=np.float32), (N_PAD, 1, 1)) * (
        np.arange(N_PAD) >= n)[:, None, None]
    eyeE = np.tile(np.eye(3, dtype=np.float32), (E_PAD, 1, 1)) * (
        np.arange(E_PAD) >= ne)[:, None, None]
    d = dict(R=pad(R0, N_PAD, (3, 3)) + eyeN, t=pad(t0, N_PAD, (3,)),
             node_valid=np.arange(N_PAD) < n,
             i=pad(ii, E_PAD, ()).astype(np.int32),
             j=pad(jj, E_PAD, ()).astype(np.int32),
             Rm=pad(Rm, E_PAD, (3, 3)) + eyeE, tm=pad(tm, E_PAD, (3,)),
             weight=pad(w, E_PAD, ()), edge_valid=np.arange(E_PAD) < ne)
    if sim3:
        d["s"] = np.ones(N_PAD, np.float32)
        sm = np.ones(E_PAD, np.float32)
        sm[ne - 1] = 1.08          # the loop sees a scale drift
        d["sm"] = sm
    return d, n


def _graphs(d, sim3):
    if sim3:
        fields = tpg.Sim3Graph._fields
        return (jpg.Sim3Graph(**{k: jnp.asarray(d[k]) for k in fields}),
                tpg.Sim3Graph(**{k: torch.tensor(d[k]) for k in fields}))
    fields = tpg.PoseGraph._fields
    return (jpg.PoseGraph(**{k: jnp.asarray(d[k]) for k in fields}),
            tpg.PoseGraph(**{k: torch.tensor(d[k]) for k in fields}))


@pytest.mark.parametrize("sim3", [False, True])
def test_edge_costs_and_jacobians_match_jax(rng, sim3):
    d, n = graph_arrays(rng, sim3)
    jg, tg = _graphs(d, sim3)
    if sim3:
        cj = jax.jit(jpg.sim3_graph_cost)(jg, jg.R, jg.t, jg.s)
        ct = tpg.sim3_graph_cost(tg, tg.R, tg.t, tg.s)
        zero = jnp.zeros(7)
        args = (jg.R[jg.i], jg.t[jg.i], jg.s[jg.i], jg.R[jg.j], jg.t[jg.j],
                jg.s[jg.j], jg.Rm, jg.tm, jg.sm)
        res = jpg._sim3_edge_residual
        r_t, Ji_t, Jj_t = tpg._with_jacobians(
            tpg._sim3_edge_residual, 7, *tpg._sim3_edge_args(tg, tg.R, tg.t,
                                                             tg.s))
    else:
        cj = jax.jit(jpg.pose_graph_cost)(jg, jg.R, jg.t)
        ct = tpg.pose_graph_cost(tg, tg.R, tg.t)
        zero = jnp.zeros(6)
        args = (jg.R[jg.i], jg.t[jg.i], jg.R[jg.j], jg.t[jg.j], jg.Rm,
                jg.tm)
        res = jpg._edge_residual
        r_t, Ji_t, Jj_t = tpg._with_jacobians(
            tpg._edge_residual, 6, *tpg._edge_args(tg, tg.R, tg.t))

    def one(*a):
        return (res(zero, zero, *a), jax.jacfwd(res, 0)(zero, zero, *a),
                jax.jacfwd(res, 1)(zero, zero, *a))

    r_j, Ji_j, Jj_j = (np.asarray(v) for v in jax.jit(jax.vmap(one))(*args))
    # float32 residuals of drifted odometry: the cost within 1e-4 relative;
    # per-edge residuals and Jacobians within 1e-4 (unit-scale entries)
    assert float(ct) == pytest.approx(float(cj), rel=1e-4)
    assert float(ct) > 0
    np.testing.assert_allclose(r_t.numpy(), r_j, atol=1e-4)
    np.testing.assert_allclose(Ji_t.numpy(), Ji_j, atol=1e-4)
    np.testing.assert_allclose(Jj_t.numpy(), Jj_j, atol=1e-4)


@pytest.mark.parametrize("sim3", [False, True])
@pytest.mark.parametrize("solver", ["dense", "cg"])
def test_optimize_padded_graph_matches_jax(rng, sim3, solver):
    d, n = graph_arrays(rng, sim3)
    jg, tg = _graphs(d, sim3)
    # the dense solve of the padded [1792, 1792] system is the slow part
    # on the CPU: 6 LM steps for it, the default 20 for CG
    iters = 6 if solver == "dense" else 20
    jc = jcfg.PoseGraphConfig(solver=solver, iters=iters)
    cfg = PoseGraphConfig(solver=solver, iters=iters)
    if sim3:
        rj = jpg.optimize_sim3_graph_jit(jg, jc)
        rt = tpg.optimize_sim3_graph(tg, cfg)
        # node scales: within 1e-3 of the reference's, one of which moved
        np.testing.assert_allclose(rt.s.numpy()[:n], np.asarray(rj.s)[:n],
                                   atol=1e-3)
        assert np.abs(np.asarray(rj.s)[:n] - 1).max() > 1e-2
    else:
        rj = jpg.optimize_pose_graph_jit(jg, jc)
        rt = tpg.optimize_pose_graph(tg, cfg)
    # both packages close the loop: the cost falls by > 10x; the final
    # costs within 5% (float32 GN / CG in two libraries)
    cj, c0 = float(rj.cost), float(rj.initial_cost)
    assert float(rt.initial_cost) == pytest.approx(c0, rel=1e-4)
    assert cj < 0.1 * c0 and float(rt.cost) < 0.1 * c0
    assert float(rt.cost) == pytest.approx(cj, rel=0.05)
    # poses: rotations within 2e-3, translations within 1e-2 on a loop of
    # radius 10 (the padded nodes stay at identity, frozen)
    np.testing.assert_allclose(rt.R.numpy()[:n], np.asarray(rj.R)[:n],
                               atol=2e-3)
    np.testing.assert_allclose(rt.t.numpy()[:n], np.asarray(rj.t)[:n],
                               atol=1e-2)
    np.testing.assert_array_equal(rt.R.numpy()[n:],
                                  np.tile(np.eye(3), (N_PAD - n, 1, 1)))
    # node 0 is the gauge
    np.testing.assert_array_equal(rt.R.numpy()[0], d["R"][0])


def test_resolve_solver_on_the_padded_graph():
    cfg = PoseGraphConfig()
    assert tpg.resolve_solver(cfg, N_PAD) == "cg"
    assert tpg.resolve_solver(cfg, 192) == "dense"
    assert tpg.resolve_solver(cfg.replace(solver="dense"), N_PAD) == "dense"

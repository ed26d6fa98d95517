"""The solver programs on the CPU: `optimize_pose_graph_jit`,
`optimize_sim3_graph_jit` (backend/pose_graph.py), `run_ba_jit` and
`run_ba_packed_jit` (backend/ba.py).

On the card each replays captured CUDA graphs (utils/graphs.LoopProgram:
an enter graph, then a step graph `cfg.iters` times); on the CPU each is
its eager function. Here: the programs equal their eager functions bit
for bit on the CPU; their uncaptured run (`LoopGraphs(graphs=False)`, the
graph program's data flow over its static buffers) equals the
eager function bit for bit, for two inputs of one key; the programs
against the JAX package's `*_jit` programs on the same inputs, at the
tolerances of tests/test_torch_pose_graph.py and tests/test_torch_ba.py;
`LoopCloser.optimize` through the program's data flow against the eager
solve; and `Tracker.prewarm_aux`, which prepares the loop closer's program
at its padded shapes and leaves the tracker as it was."""

import copy

import jax
import numpy as np
import pytest
import torch

from test_torch_ba import _problems
from test_torch_pose_graph import trajectory
from visualslam_tpu.backend import ba as jba
from visualslam_tpu.backend import pose_graph as jpg
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.backend import ba as tba
from visualslam_tpu_torch.backend import pose_graph as tpg
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.slam.loop_closure import LoopCloser
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.utils.config import (
    FAST_CONFIG,
    BAConfig,
    PoseGraphConfig,
)
from visualslam_tpu_torch.utils.graphs import LoopGraphs, _leaves


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# a small padded graph keeps the solves cheap on the CPU: 40 nodes of a
# drifting loop padded to 48 (the dense solve: a [288, 288] or [336, 336]
# system), with 4 edges a node as LoopCloser.optimize pads them
PAD = (48, 192)


def graph_arrays(rng, sim3: bool, N: int, E: int):
    """tests/test_torch_pose_graph.graph_arrays' loop, padded to N nodes
    and E edges (numpy)."""
    R0, t0, R_gt, t_gt = trajectory(rng)
    n = len(R0)
    ii = list(range(n - 1)) + [0]
    jj = list(range(1, n)) + [n - 1]
    Rm = [R0[k].T @ R0[k + 1] for k in range(n - 1)]
    tm = [R0[k].T @ (t0[k + 1] - t0[k]) for k in range(n - 1)]
    Rm.append(R_gt[0].T @ R_gt[n - 1])
    tm.append(R_gt[0].T @ (t_gt[n - 1] - t_gt[0]))
    w = [1.0] * (n - 1) + [0.5 * 4.0]
    ne = len(ii)

    def pad(a, target, tail):
        out = np.zeros((target,) + tail, np.float32)
        out[:len(a)] = np.asarray(a)
        return out

    eyeN = np.tile(np.eye(3, dtype=np.float32), (N, 1, 1)) * (
        np.arange(N) >= n)[:, None, None]
    eyeE = np.tile(np.eye(3, dtype=np.float32), (E, 1, 1)) * (
        np.arange(E) >= ne)[:, None, None]
    d = dict(R=pad(R0, N, (3, 3)) + eyeN, t=pad(t0, N, (3,)),
             node_valid=np.arange(N) < n,
             i=pad(ii, E, ()).astype(np.int32),
             j=pad(jj, E, ()).astype(np.int32),
             Rm=pad(Rm, E, (3, 3)) + eyeE, tm=pad(tm, E, (3,)),
             weight=pad(w, E, ()), edge_valid=np.arange(E) < ne)
    if sim3:
        d["s"] = np.ones(N, np.float32)
        sm = np.ones(E, np.float32)
        sm[ne - 1] = 1.08          # the loop sees a scale drift
        d["sm"] = sm
    return d, n


def _graph(d, sim3: bool):
    cls = tpg.Sim3Graph if sim3 else tpg.PoseGraph
    return cls(**{k: torch.tensor(d[k]) for k in cls._fields})


def _jax_graph(d, sim3: bool):
    cls = jpg.Sim3Graph if sim3 else jpg.PoseGraph
    return cls(**{k: jax.numpy.asarray(d[k]) for k in cls._fields})


def _programs(sim3: bool):
    if sim3:
        return tpg.optimize_sim3_graph_jit, jpg.optimize_sim3_graph_jit
    return tpg.optimize_pose_graph_jit, jpg.optimize_pose_graph_jit


def _equal(a, b) -> bool:
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# few LM iterations and CG steps: the data flow, not convergence
PG_CFG = {"dense": PoseGraphConfig(solver="dense", iters=3),
          "cg": PoseGraphConfig(solver="cg", iters=3, cg_iters=12)}
BA_PROGRAMS = {"run_ba_jit": tba.run_ba_jit,
               "run_ba_packed_jit": tba.run_ba_packed_jit}


@pytest.mark.parametrize("sim3", [False, True])
def test_pose_graph_programs_on_the_cpu_are_the_eager_functions(rng, sim3):
    d, _ = graph_arrays(rng, sim3, *PAD)
    g = _graph(d, sim3)
    prog, _ = _programs(sim3)
    cfg = PG_CFG["cg"]
    assert prog.fn is (tpg.optimize_sim3_graph if sim3
                       else tpg.optimize_pose_graph)
    assert _equal(prog(g, cfg), prog.fn(g, cfg))
    prog.prepare(g, cfg)
    assert not prog.captured


@pytest.mark.parametrize("name", sorted(BA_PROGRAMS))
def test_ba_programs_on_the_cpu_are_the_eager_functions(rng, name):
    _, p, _ = _problems(rng, pad=True, n_cams=4, n_lms=60)
    prog = BA_PROGRAMS[name]
    cfg = BAConfig(iters=3)
    assert prog.fn is (tba.run_ba if name == "run_ba_jit"
                       else tba.run_ba_packed)
    assert _equal(prog(p, cfg), prog.fn(p, cfg))
    assert not prog.captured


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("sim3", [False, True])
def test_pose_graph_uncaptured_program_equals_the_eager_function(rng, sim3,
                                                            solver):
    """The graph program's data flow (enter, then the step over the static
    carry cfg.iters times), uncaptured: the eager solve's bits, for two
    graphs of one key through one LoopGraphs (stale static state would part
    the second)."""
    cfg = PG_CFG[solver]
    prog, _ = _programs(sim3)
    gs = []
    for k in range(2):
        d, _ = graph_arrays(np.random.default_rng(k), sim3, *PAD)
        gs.append(_graph(d, sim3))
    uncaptured = LoopGraphs(prog, gs[0], cfg, graphs=False)
    out = [uncaptured.run(g) for g in gs]
    for g, got in zip(gs, out):
        want = prog.fn(g, cfg)
        assert _equal(got, want)
        assert float(want.cost) < float(want.initial_cost)
    # the results handed back are copies: the second run left the first's
    assert not torch.equal(out[0].t, out[1].t)
    assert _equal(out[0], prog.fn(gs[0], cfg))


@pytest.mark.parametrize("name", sorted(BA_PROGRAMS))
@pytest.mark.parametrize("solver", ["schur_dense", "schur_cg", "schur_mf"])
def test_ba_uncaptured_program_equals_the_eager_function(rng, solver, name):
    cfg = BAConfig(iters=3, solver=solver, cg_iters=8)
    prog = BA_PROGRAMS[name]
    _, p, _ = _problems(rng, pad=True, n_cams=4, n_lms=60, pix_noise=1e-3)
    g = torch.Generator().manual_seed(1)
    ps = [p, p._replace(X=p.X + 0.01 * torch.randn(p.X.shape, generator=g),
                        t=p.t + 0.01 * torch.randn(p.t.shape, generator=g))]
    uncaptured = LoopGraphs(prog, ps[0], cfg, graphs=False)
    out = [uncaptured.run(q) for q in ps]
    for q, got in zip(ps, out):
        assert _equal(got, prog.fn(q, cfg))
    assert not torch.equal(_leaves(out[0])[0], _leaves(out[1])[0])
    assert _equal(out[0], prog.fn(ps[0], cfg))


@pytest.mark.parametrize("solver", ["dense", "cg"])
@pytest.mark.parametrize("sim3", [False, True])
def test_pose_graph_programs_match_jax(rng, sim3, solver):
    """The port's program, run uncaptured, against the JAX
    package's program on the same padded graph, at
    tests/test_torch_pose_graph.py's tolerances:
    the initial cost within 1e-4 relative, both costs below a tenth of it
    and within 5% of each other (float32 GN / CG in two libraries),
    rotations within 2e-3, translations within 1e-2 on a loop of radius
    10, scales within 1e-3, the padded nodes at identity. On the small
    graph 4 dense and 10 CG steps meet them."""
    d, n = graph_arrays(rng, sim3, *PAD)
    iters = 4 if solver == "dense" else 10
    cfg = PoseGraphConfig(solver=solver, iters=iters)
    prog, jprog = _programs(sim3)
    g = _graph(d, sim3)
    rt = LoopGraphs(prog, g, cfg, graphs=False).run(g)
    rj = jprog(_jax_graph(d, sim3),
               jcfg.PoseGraphConfig(solver=solver, iters=iters))
    cj, c0 = float(rj.cost), float(rj.initial_cost)
    assert float(rt.initial_cost) == pytest.approx(c0, rel=1e-4)
    assert cj < 0.1 * c0 and float(rt.cost) < 0.1 * c0
    assert float(rt.cost) == pytest.approx(cj, rel=0.05)
    np.testing.assert_allclose(rt.R.numpy()[:n], np.asarray(rj.R)[:n],
                               atol=2e-3)
    np.testing.assert_allclose(rt.t.numpy()[:n], np.asarray(rj.t)[:n],
                               atol=1e-2)
    if sim3:
        np.testing.assert_allclose(rt.s.numpy()[:n], np.asarray(rj.s)[:n],
                                   atol=1e-3)
    N = d["R"].shape[0]
    np.testing.assert_array_equal(rt.R.numpy()[n:],
                                  np.tile(np.eye(3), (N - n, 1, 1)))


@pytest.mark.parametrize("solver", ["schur_dense", "schur_cg", "schur_mf"])
def test_ba_programs_match_jax(rng, solver):
    """run_ba_jit and run_ba_packed_jit, run uncaptured,
    against the JAX package's run_ba_jit / run_ba_packed_jit on the padded
    window problem, at tests/test_torch_ba.py's tolerances: the initial
    cost within 1e-5 relative, the final cost below a tenth of it and
    within 1e-2 of the reference's (float32 sums in another order part
    the LM's accepts on near-ties), rotations within 1e-4, translations
    within 1e-3, points within 1e-2, the padding as it was."""
    jp, tp, _ = _problems(rng, pad=True, n_cams=6, n_lms=200,
                          pix_noise=1e-3)
    cfg, jc = BAConfig(iters=10, solver=solver), jcfg.BAConfig(
        iters=10, solver=solver)
    res = LoopGraphs(tba.run_ba_jit, tp, cfg, graphs=False).run(tp)
    packed = LoopGraphs(tba.run_ba_packed_jit, tp, cfg, graphs=False).run(tp)
    C, L = tp.R.shape[0], tp.X.shape[0]
    want = jba.run_ba_jit(jp, jc)
    wpk = jba.unpack_ba_result(np.asarray(jba.run_ba_packed_jit(jp, jc)),
                               C, L)
    got_pk = tba.unpack_ba_result(packed, C, L)
    for (R, t, X, cost, init), (wR, wt, wX, wc, wi) in (
            ((res.R.numpy(), res.t.numpy(), res.X.numpy(), res.cost.item(),
              res.initial_cost.item()),
             (np.asarray(want.R), np.asarray(want.t), np.asarray(want.X),
              float(want.cost), float(want.initial_cost))),
            (got_pk, wpk)):
        assert cost < 0.1 * init
        assert init == pytest.approx(wi, rel=1e-5)
        assert cost == pytest.approx(wc, rel=1e-2, abs=1e-9)
        np.testing.assert_allclose(R, wR, atol=1e-4)
        np.testing.assert_allclose(t, wt, atol=1e-3)
        np.testing.assert_allclose(X, wX, atol=1e-2)
        np.testing.assert_array_equal(R[-1], np.eye(3))
        np.testing.assert_array_equal(X[-8:], 0.0)
    # the packed program packs the unpacked one's result
    np.testing.assert_array_equal(got_pk[0], res.R.numpy())
    assert got_pk[3:] == (res.cost.item(), res.initial_cost.item())


def _closer(sim3: bool, program=None) -> LoopCloser:
    lc = LoopCloser(np.array([500, 500, 320, 240], np.float32),
                    FAST_CONFIG.match,
                    PoseGraphConfig(max_nodes=48, max_edges=192, iters=4,
                                    cg_iters=16, cg_threshold=32),
                    use_sim3=sim3, device="cpu")
    if program is not None:
        lc.program = program
    return lc


@pytest.mark.parametrize("sim3", [False, True])
def test_loop_closer_optimize_through_the_program(rng, sim3):
    """LoopCloser.optimize with its program's data flow (run
    uncaptured) against the same closer on the eager solve: corrected poses,
    scales, world corrections and centres equal; the graph it hands the
    program is padded to its capacity."""
    seen = []

    def driven(g, cfg):
        seen.append(g)
        return LoopGraphs(tpg.optimize_sim3_graph_jit if sim3
                          else tpg.optimize_pose_graph_jit, g, cfg,
                          graphs=False).run(g)

    R0, t0, _, _ = trajectory(rng)
    out = []
    for lc in (_closer(sim3, driven), _closer(sim3)):
        for k in range(len(R0)):
            lc.add_keyframe_light(k, R0[k], t0[k])
        lc.add_device_edge(0, len(R0) - 1, R0[0], t0[0], 99, 1.05)
        out.append((lc.optimize(), lc))
    (ca, a), (cb, b) = out
    np.testing.assert_array_equal(ca, cb)
    for (Ra, ta), (Rb, tb) in zip(a.corrected, b.corrected):
        np.testing.assert_array_equal(Ra, Rb)
        np.testing.assert_array_equal(ta, tb)
    assert a.corrected_scale == b.corrected_scale
    for x, y in zip(a.last_corrections, b.last_corrections):
        for u, v in zip(x, y):
            np.testing.assert_array_equal(u, v)
    assert len(seen) == 1
    assert type(seen[0]) is (tpg.Sim3Graph if sim3 else tpg.PoseGraph)
    assert seen[0].R.shape == (48, 3, 3) and seen[0].i.shape == (192,)


def test_prewarm_aux_prepares_the_loop_program_and_keeps_the_state():
    """prewarm_aux hands the loop closer's program a graph at the padded
    shapes of the next closure (Sim(3), max_nodes x max_edges, on the
    tracker's device) and leaves the tracker's map, frames, loop closer
    and engine persist as they were."""
    import chip_smoke

    cfg = FAST_CONFIG.replace(
        pyramid=FAST_CONFIG.pyramid.replace(num_octaves=2),
        sift=FAST_CONFIG.sift.replace(max_keypoints_per_octave=128,
                                      max_keypoints=256))
    seq = SyntheticSequence(num_frames=12, h=120, w=160, n_dots=400)
    imgs = np.stack([seq.frame(k) for k in range(12)])
    t = Tracker(cfg, seq.intrinsics, device="cpu")
    t.process_batch(imgs[:8], 0)
    t.process_batch(imgs[8:], 8)
    assert t._eng_persist is not None and len(t.loop_closer.entries) >= 2
    before = copy.deepcopy(t)
    prepared = []
    prog = t.loop_closer.program
    t.loop_closer.program = lambda g, c: pytest.fail("prewarm_aux ran a "
                                                     "solve")
    t.loop_closer.program.prepare = lambda g, c: prepared.append((g, c))
    t.prewarm_aux()
    assert prog is tpg.optimize_sim3_graph_jit and cfg.loop.sim3
    (g, c), = prepared
    assert type(g) is tpg.Sim3Graph and c == cfg.pose_graph
    assert g.R.shape == (cfg.pose_graph.max_nodes, 3, 3)
    assert g.i.shape == (cfg.pose_graph.max_edges,)
    assert all(x.device.type == "cpu" for x in _leaves(g))
    assert not g.node_valid.any() and not g.edge_valid.any()
    assert chip_smoke.state_diffs(before, t) == []
    assert len(t.loop_closer.loop_edges) == len(before.loop_closer.loop_edges)
    assert t.loop_closer.corrected is None

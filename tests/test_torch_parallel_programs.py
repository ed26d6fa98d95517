"""The sharded programs on the CPU: `parallel.dist_ba.run_ba_sharded`
(psum and ring), `parallel.traj_ba.run_ba_traj_sharded` (dense and
matrix-free), `parallel.dist_match.sharded_2nn`,
`parallel.dryrun.data_parallel_frontend` and the dry run's
`track_step_jit`.

On a mesh whose shards are all one card each replays captured CUDA graphs
(parallel/programs.py: the LM loops as utils/graphs.LoopPrograms, the
2-NN and the frontend as seedless GraphPrograms); on the CPU each is its
eager function. Here, on a 4-shard virtual CPU mesh: each public name is
its program's eager function bit for bit, with nothing captured; the
program's data flow run uncaptured over its static buffers
(`LoopGraphs(graphs=False)` / `ProgramGraph(graphs=False)`) equals the
eager function bit for bit for two inputs of one key and hands back
copies; each result matches the JAX package's on conftest's virtual
devices at the tolerances of tests/test_torch_{dist_ba,traj_ba,
dist_match,frontend,host_programs}.py; and the keys part by reduction,
axis and mesh devices, with a mesh over distinct devices run eagerly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_ba import make_ba_problem
from test_dist_match import _full_2nn
from test_torch_tracking import DENSE_POSE_TOL
from test_torch_frontend_program import (
    SIFT_FAST,
    _StandInCapture,
    _frames,
    _jax,
    _sift_close,
)
from visualslam_tpu.frontend import detect_and_describe as jdetect
from visualslam_tpu.parallel import dist_ba as jdist
from visualslam_tpu.parallel import dist_match as jmatch
from visualslam_tpu.parallel import traj_ba as jtraj
from visualslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from visualslam_tpu.slam import track_step as jts
from visualslam_tpu.utils.config import BAConfig as JBAConfig
from visualslam_tpu_torch.backend.ba import BAProblem
from visualslam_tpu_torch.frontend import SiftFrontend
from visualslam_tpu_torch.ops.cuda import KERNELS, PLAIN
from visualslam_tpu_torch.parallel import dist_ba, dist_match, dryrun, traj_ba
from visualslam_tpu_torch.parallel import programs as pprog
from visualslam_tpu_torch.parallel.mesh import make_mesh
from visualslam_tpu_torch.slam import track_step as tts
from visualslam_tpu_torch.utils import graphs
from visualslam_tpu_torch.utils.config import BAConfig
from visualslam_tpu_torch.utils.convert import from_numpy

N = 4
CPU = torch.device("cpu")
MESH = make_mesh(N, devices=[CPU] * N)
DATA_MESH = make_mesh(N, "data", [CPU] * N)
# tests/test_torch_dist_ba.py's and tests/test_torch_traj_ba.py's solves
DIST_CFG = BAConfig(iters=8)
TRAJ_CFG = {"dense": dict(iters=6, cg_iters=64, max_cameras=8),
            "mf": dict(iters=8, cg_iters=64, max_cameras=8,
                       solver="schur_mf")}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jp):
    return from_numpy(BAProblem, jax.tree_util.tree_map(np.asarray, jp),
                      device="cpu")


def _equal(a, b) -> bool:
    la, lb = graphs._leaves(a), graphs._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _perturbed(sp, seed: int):
    """The sharded problem with its state moved: another input of the same
    key (the indices, so the shard padding, unchanged)."""
    g = torch.Generator().manual_seed(seed)
    return sp._replace(X=sp.X + 0.01 * torch.randn(sp.X.shape, generator=g),
                       t=sp.t + 0.01 * torch.randn(sp.t.shape, generator=g))


def _dist_problem(seed: int = 0):
    jp, *_ = make_ba_problem(np.random.default_rng(seed), n_cams=5,
                             n_lms=320)
    return jp, dist_ba.shard_problem(_port(jp), N)


def _traj_problem(seed: int = 0):
    jp, *_ = make_ba_problem(np.random.default_rng(seed), n_cams=8,
                             n_lms=160)
    return jp, traj_ba.shard_problem_trajectory(_port(jp), N)


def _match_inputs(seed: int):
    r = np.random.default_rng(seed)
    Ka, Kb, D = 96, 1000, 64
    qa = r.standard_normal((Ka, D)).astype(np.float32)
    kb = r.standard_normal((Kb, D)).astype(np.float32)
    vb = r.random(Kb) > 0.1
    return qa, kb, vb


def _match_call(seed: int) -> tuple:
    qa, kb, vb = _match_inputs(seed)
    kb_s, vb_s = dist_match.shard_descriptors(kb, vb, N, device="cpu")
    return torch.from_numpy(qa), kb_s, vb_s, MESH


# FAST at 2 octaves and 256 keypoints (tests/test_torch_frontend.py), one
# 96x256 frame a shard
FRONTEND = SiftFrontend(SIFT_FAST)
FRAMES = _frames((96, 256), n=N + 1)


def _track_inputs(moved: bool):
    x = dryrun.dryrun_track_inputs(CPU)
    if moved:
        st = x[3]
        x = x[:3] + (st._replace(t=st.t + 0.1),) + x[4:]
    return x


TRACK_CFG = ((dryrun.DRYRUN_TRACK_CONFIG, *dryrun.DRYRUN_TRACK_ARGS),
             KERNELS)


def _cases() -> dict:
    """name -> (program, public call of input k, (x, cfg) of input k):
    inputs 0 and 1 share a key."""
    out = {}
    for reduce in ("psum", "ring"):
        sps = [_dist_problem()[1]]
        sps.append(_perturbed(sps[0], 1))
        out[f"dist_ba-{reduce}"] = (
            dist_ba.run_ba_sharded.program,
            lambda k, s=sps, r=reduce: dist_ba.run_ba_sharded(
                s[k], DIST_CFG, MESH, reduce=r),
            lambda k, s=sps, r=reduce: dist_ba.sharded_ba_args(
                s[k], DIST_CFG, MESH, reduce=r))
    for solver, kw in TRAJ_CFG.items():
        sps = [_traj_problem()[1]]
        sps.append(_perturbed(sps[0], 1))
        cfg = BAConfig(**kw)
        out[f"traj_ba-{solver}"] = (
            traj_ba.run_ba_traj_sharded.program,
            lambda k, s=sps, c=cfg: traj_ba.run_ba_traj_sharded(s[k], c,
                                                                MESH),
            lambda k, s=sps, c=cfg: traj_ba.traj_ba_args(s[k], c, MESH))
    out["sharded_2nn"] = (
        dist_match.sharded_2nn.program,
        lambda k: dist_match.sharded_2nn(*_match_call(k)),
        lambda k: dist_match.sharded_2nn_args(*_match_call(k)))
    out["data_parallel_frontend"] = (
        dryrun.data_parallel_frontend.program,
        lambda k: dryrun.data_parallel_frontend(FRONTEND, FRAMES[k:k + N],
                                                DATA_MESH),
        lambda k: dryrun.frontend_args(FRONTEND, FRAMES[k:k + N],
                                       DATA_MESH))
    out["dryrun_track_step"] = (
        tts.track_step_jit.program,
        lambda k: tts.track_step_jit(*_track_inputs(k == 1),
                                     TRACK_CFG[0][0], *TRACK_CFG[0][1:]),
        lambda k: (_track_inputs(k == 1), TRACK_CFG))
    return out


CASES = _cases()
LOOPS = (dist_ba.run_ba_sharded.program, traj_ba.run_ba_traj_sharded.program)


def _tuple(out):
    """The public frontend returns lists (the eager loop's types); the
    program tuples."""
    return tuple(tuple(v) if isinstance(v, list) else v for v in out)


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_on_the_cpu_is_its_eager_function(case):
    prog, public, args = CASES[case]
    x, cfg = args(0)
    assert not prog._replays(x, cfg)
    keys = list(prog.captured)
    assert _equal(_tuple(public(0)), prog.fn(x, cfg))
    assert list(prog.captured) == keys


@pytest.mark.parametrize("case", sorted(CASES))
def test_uncaptured_program_equals_the_eager_function(case):
    """The program's data flow over its static buffers, uncaptured (for a
    loop: enter, then the step over the static carry cfg.iters times, a
    tuple of per-shard tuples): the eager function's bits for two inputs
    of one key; the results handed back are copies, so the second run
    leaves the first's."""
    prog, _, args = CASES[case]
    xs = [args(k) for k in range(2)]
    assert graphs._signature(xs[0][0]) == graphs._signature(xs[1][0])
    kind = graphs.LoopGraphs if prog in LOOPS else graphs.ProgramGraph
    uncaptured = kind(prog, *xs[0], graphs=False)
    got = [uncaptured.run(x) for x, _ in xs]
    for g, (x, cfg) in zip(got, xs):
        assert _equal(g, prog.fn(x, cfg))
    assert not _equal(got[0], got[1])
    assert _equal(got[0], prog.fn(*xs[0]))


def _uncaptured(case: str, k: int = 0):
    prog, _, args = CASES[case]
    x, cfg = args(k)
    kind = graphs.LoopGraphs if prog in LOOPS else graphs.ProgramGraph
    return kind(prog, x, cfg, graphs=False).run(x)


@pytest.mark.parametrize("reduce", ["psum", "ring"])
def test_sharded_ba_program_matches_jax(reduce):
    """The program's data flow against the JAX package's run_ba_sharded on
    4 of conftest's virtual devices, at tests/test_torch_dist_ba.py's
    tolerances."""
    jp, sp = _dist_problem()
    got = _uncaptured(f"dist_ba-{reduce}")
    ref = jdist.run_ba_sharded(jdist.shard_problem(jp, N), JBAConfig(iters=8),
                               jmake_mesh(N, axis="shard"), reduce=reduce)
    assert float(got.cost) < float(got.initial_cost) * 1e-3
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=5e-4)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-3)
    np.testing.assert_allclose(
        dist_ba.unshard_points(got.X, sp.lm_order).numpy(),
        np.asarray(jdist.unshard_points(ref.X, sp.lm_order)), atol=2e-2)


@pytest.mark.parametrize("solver", sorted(TRAJ_CFG))
def test_traj_sharded_program_matches_jax(solver):
    """The program's data flow against the JAX package's
    run_ba_traj_sharded at Cs = 2 (8 cameras over 4 shards), at
    tests/test_torch_traj_ba.py's multi-block tolerances: rotations within
    1e-3, translations within 1e-2, final costs within 1e-2."""
    jp, sp = _traj_problem()
    got = _uncaptured(f"traj_ba-{solver}")
    jsp = jtraj.shard_problem_trajectory(jp, N)
    ref = jtraj.run_ba_traj_sharded(jsp, JBAConfig(**TRAJ_CFG[solver]),
                                    jmake_mesh(N, axis="shard"))
    L = sp.X.shape[1] * N
    R, t, _ = traj_ba.unshard_traj(got.R, got.t, got.X, sp.lm_order, L)
    Rj, tj, _ = jtraj.unshard_traj(ref.R, ref.t, ref.X, jsp.lm_order, L)
    assert float(got.cost) < float(got.initial_cost) * 1e-3
    np.testing.assert_allclose(float(got.initial_cost),
                               float(ref.initial_cost), rtol=1e-5)
    np.testing.assert_allclose(R, Rj, atol=1e-3)
    np.testing.assert_allclose(t, tj, atol=1e-2)
    np.testing.assert_allclose(float(got.cost), float(ref.cost), rtol=1e-2,
                               atol=1e-9)


def test_sharded_2nn_program_matches_jax_and_full():
    """tests/test_torch_dist_match.py's criteria: distances within rtol
    2e-4, atol 1e-4 of the JAX package's and of the full matrix, indices
    equal off near-ties."""
    qa, kb, vb = _match_inputs(0)
    best, second, idx = (v.numpy() for v in _uncaptured("sharded_2nn"))
    jkb, jvb = jmatch.shard_descriptors(kb, vb, N)
    jb, js, ji = (np.asarray(v) for v in jmatch.sharded_2nn(
        jnp.asarray(qa), jkb, jvb, jmake_mesh(N, axis="shard")))
    want_b, want_s, want_i = _full_2nn(qa, kb, vb)
    assert idx.dtype == np.int32
    for got, ref in ((best, want_b), (second, want_s), (best, jb),
                     (second, js)):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-4)
    close = np.abs(want_s - want_b) < 1e-4
    assert ((idx == want_i) | close).mean() > 0.99
    assert ((idx == ji) | close).mean() > 0.99


def test_data_parallel_frontend_program_matches_jax():
    """Each shard's features against the JAX package's frontend under
    shard_map over 4 of conftest's virtual devices with the psum of the
    detection counts (the JAX dry run's data-parallel step), at
    tests/test_torch_frontend.py's criteria; the psum'd totals apart by
    no more than the per-frame counts may be."""
    feats, total = _uncaptured("data_parallel_frontend")
    jc = _jax(SIFT_FAST)

    def step(batch):
        f = jax.vmap(lambda im: jdetect(im, jc))(batch)
        return f, jax.lax.psum(
            jnp.sum(f.keypoints.valid.astype(jnp.int32)), "data")

    smapped = jax.shard_map(step, mesh=jmake_mesh(N, axis="data"),
                            in_specs=P("data"), out_specs=(P("data"), P()),
                            check_vma=False)     # the Pallas kernels inside
    with jax.default_matmul_precision("float32"):
        want, want_total = jax.jit(smapped)(jnp.asarray(FRAMES[:N]))
    want = jax.tree_util.tree_map(np.asarray, want)
    for s in range(N):
        _sift_close(jax.tree_util.tree_map(lambda a, s=s: a[s:s + 1], want),
                    feats[s], 1)
    n_port = sum(int(f.keypoints.valid.sum()) for f in feats)
    assert [int(v) for v in total] == [n_port] * N
    assert abs(n_port - int(want_total)) <= max(2 * N,
                                                0.05 * int(want_total))


def test_dryrun_track_step_program_matches_jax():
    """The dry run's track step (random features: no match survives in
    either package, the tracker's lost path) against the JAX package's
    track_step_jit on the same inputs: poses and stats within
    tests/test_torch_host_programs.py's tolerances, the match slots
    equal."""
    x = dryrun.dryrun_track_inputs(CPU)
    got = _uncaptured("dryrun_track_step")
    jc = _jax(dryrun.DRYRUN_TRACK_CONFIG)

    def J(t):
        return type(t)(*(jnp.asarray(v.numpy()) for v in t))

    kf, lmap, f, st, intr = x
    jf = jts.Features(J(f.keypoints), jnp.asarray(f.descriptors.numpy()))
    want = jts.track_step_jit(J(kf), J(lmap), jf, J(st),
                              jnp.asarray(intr.numpy()), jc,
                              *dryrun.DRYRUN_TRACK_ARGS)
    for n in ("R", "t", "vel"):
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   np.asarray(getattr(want, n)),
                                   atol=DENSE_POSE_TOL, err_msg=n)
    np.testing.assert_allclose(got.stats.numpy(), np.asarray(want.stats),
                               rtol=1e-4, atol=DENSE_POSE_TOL)
    np.testing.assert_array_equal(got.assoc_i.numpy(),
                                  np.asarray(want.assoc_i))


@pytest.fixture()
def stand_in(monkeypatch):
    """The captured branch's data flow on the CPU: a stand-in capture and
    the sharded programs made to replay; their caches start and end
    empty."""
    progs = (dist_ba.run_ba_sharded.program,
             traj_ba.run_ba_traj_sharded.program,
             dist_match.sharded_2nn.program,
             dryrun.data_parallel_frontend.program)
    for p in progs:
        p.captured.clear()
    monkeypatch.setattr(graphs, "_Capture", _StandInCapture)
    for cls in (pprog.MeshLoopProgram, pprog.MeshGraphProgram):
        monkeypatch.setattr(cls, "_replays", lambda self, x, cfg: True)
    yield
    for p in progs:
        p.captured.clear()


def test_keys_part_by_reduce_axis_and_mesh_devices(stand_in):
    """On the captured branch (stand-in capture) one problem keys apart
    under psum and ring, another axis name and a mesh of other devices,
    and each key's replay equals the eager function; a repeated call
    replays its key."""
    prog = dist_ba.run_ba_sharded.program
    _, sp = _dist_problem()
    cpu0 = torch.device("cpu", 0)
    calls = [(MESH, "shard", "psum"), (MESH, "shard", "ring"),
             (make_mesh(N, "other", [CPU] * N), "other", "psum"),
             (make_mesh(N, devices=[cpu0] * N), "shard", "psum")]
    for mesh, axis, reduce in calls:
        got = dist_ba.run_ba_sharded(sp, DIST_CFG, mesh, axis, reduce)
        x, key = dist_ba.sharded_ba_args(sp, DIST_CFG, mesh, axis, reduce)
        assert _equal(got, prog.fn(x, key))
    keys = [k for _, k in prog.captured]
    assert len(keys) == len(set(keys)) == 4
    assert {(k.axis, k.reduce, k.devices[0]) for k in keys} == {
        ("shard", "psum", CPU), ("shard", "ring", CPU),
        ("other", "psum", CPU), ("shard", "psum", cpu0)}
    dist_ba.run_ba_sharded(sp, DIST_CFG, MESH)
    assert len(prog.captured) == 4
    assert list(prog.captured)[-1][1].reduce == "psum"


def test_frontend_keys_on_config_and_kernel_set(stand_in):
    """The data-parallel frontend keys on its module's config and kernel
    set and on the mesh; its replay equals the eager function."""
    prog = dryrun.data_parallel_frontend.program
    frames = FRAMES[:N]
    for fe in (FRONTEND, SiftFrontend(SIFT_FAST.replace(
            keyframe_min_inliers=SIFT_FAST.keyframe_min_inliers + 1))):
        feats, total = dryrun.data_parallel_frontend(fe, frames, DATA_MESH)
        x, cfg = dryrun.frontend_args(fe, frames, DATA_MESH)
        assert _equal((tuple(feats), tuple(total)), prog.fn(x, cfg))
    assert len(prog.captured) == 2
    assert {k[1][0].cfg for k in prog.captured} == {
        FRONTEND.cfg, FRONTEND.cfg.replace(
            keyframe_min_inliers=SIFT_FAST.keyframe_min_inliers + 1)}


def test_a_mesh_over_distinct_devices_runs_eagerly():
    """A program replays only where every shard is one CUDA device: a
    virtual mesh of one card, not a mesh over several cards, not the CPU;
    and never with the plain kernel set, whose solvers read the host."""
    cuda = [torch.device("cuda", i) for i in range(N)]
    assert pprog.on_one_card((cuda[0],) * N)
    assert not pprog.on_one_card(tuple(cuda))
    assert not pprog.on_one_card((CPU,) * N)
    x = (torch.zeros(2),)
    g = dryrun.data_parallel_frontend.program
    key = pprog.MeshKey(SIFT_FAST, (CPU,) * N, "data")
    assert not g._replays(x, (key, KERNELS))
    assert not g._replays(x, (key, PLAIN))
    loop = dist_ba.run_ba_sharded.program
    assert not loop._replays(x, pprog.MeshKey(DIST_CFG, tuple(cuda),
                                              "shard"))
    assert pprog.mesh_input(x, tuple(cuda)) is x

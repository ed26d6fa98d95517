"""The engine batch as the port's engine_programs run it: the body split
into engine_step / engine_promote (slam/engine.py) and the graph program's
driver over its static buffers, on the engine tests' fixture
(tests/test_torch_engine.world: a synthetic scene, two keyframes, a loop
database, a kill list).

On the CPU `engine_programs(...)["batch"]` is run_engine_batch itself; the
graph program's own data flow (the caller's state copied into static
buffers, the frame index advanced in place, the step / promote / pack
bodies, the copies handed back) runs here through
`_BatchGraphs(graphs=False)`, which replays the same bodies without a
capture. Both must equal run_engine_batch bit for bit. Against the JAX
package's run_engine_batch the split body is held to the engine tests'
tolerances, with inactive frames and with every frame promoted (prom_n
reaching P)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_engine import (
    B,
    INTR,
    LOOP_INT,
    MAX_DEPTH,
    OK_MIN,
    POINT_RTOL,
    POINT_TOL,
    POSE_TOL,
    W,
    _close,
    _np,
    world,  # noqa: F401  (the module-scoped fixture)
)
from visualslam_tpu.slam import engine as jeng
from visualslam_tpu_torch.ops.cuda import KERNELS
from visualslam_tpu_torch.ops.cuda import triangulate as tri
from visualslam_tpu_torch.slam import engine as teng


def _kill_gen(w):
    """The fixture's kill generations: slot 5's moved on (spared)."""
    kg = np.zeros(len(w.kill), np.int32)
    kg[5] = 1
    return kg


def _tdyn(start, stop, w):
    return teng.EngineDyn(frame_base=3, start=start, stop=stop,
                          kill=torch.from_numpy(w.kill),
                          kill_gen=torch.from_numpy(_kill_gen(w)))


def _static_driver(w, cfg):
    prog = teng.EngineProgram(cfg, OK_MIN, MAX_DEPTH)
    return teng._BatchGraphs(prog, w.tp, _tdyn(0, B, w), w.tf,
                             torch.tensor(INTR), KERNELS, graphs=False)


def _equal(a, b, what):
    for name, x, y in zip(teng.EnginePersist._fields, a, b):
        assert x.dtype == y.dtype and torch.equal(x, y), (what, name)


def test_cpu_batch_program_is_run_engine_batch(world):  # noqa: F811
    """engine_programs' four keys (the database correction and append
    programs over apply_correction and db_append_host); on the CPU "batch"
    runs run_engine_batch and equals the fixture's call bit for bit."""
    progs = teng.engine_programs(world.cfg, OK_MIN, MAX_DEPTH)
    assert set(progs) == {"batch", "relocalize", "db_correct", "db_append"}
    assert progs is teng.engine_programs(world.cfg, OK_MIN, MAX_DEPTH)
    assert progs["db_correct"].fn is teng.apply_correction
    assert progs["db_append"].fn is teng.db_append_host
    packed, p2 = progs["batch"](world.tp, _tdyn(0, B, world), world.tf,
                                torch.tensor(INTR))
    assert torch.equal(packed, world.tpacked)
    _equal(p2, world.tp2, "program")
    assert not progs["batch"].captured


def test_static_driver_equals_run_engine_batch_twice(world):  # noqa: F811
    """The graph program's data flow over its static buffers, uncaptured:
    the packed buffer and persist of run_engine_batch bit for bit, twice
    from the same input persist, the input untouched and the returned
    persist not aliasing the program's buffers."""
    drv = _static_driver(world, world.cfg)
    for run in range(2):
        packed, p2 = drv.run(world.tp, _tdyn(0, B, world), world.tf,
                             torch.tensor(INTR))
        assert torch.equal(packed, world.tpacked), run
        _equal(p2, world.tp2, f"run {run}")
        for a, b in zip(p2, drv.persist):
            assert a.data_ptr() != b.data_ptr()
    for name, a, b in zip(teng.EnginePersist._fields, world.before,
                          world.tp):
        assert torch.equal(a, b), name


def _decode(packed, cfg, P):
    return teng.decode_packed(np.asarray(packed), B, cfg.match.max_matches,
                              P, W, cfg.local_map_size)


def _jax_batch(w, jc, start, stop):
    jdyn = jeng.EngineDyn(frame_base=jnp.int32(3), start=jnp.int32(start),
                          stop=jnp.int32(stop), kill=jnp.asarray(w.kill),
                          kill_gen=jnp.asarray(_kill_gen(w)))
    packed, p2 = jax.jit(jeng.run_engine_batch, static_argnums=(4, 5, 6))(
        w.jp, jdyn, w.jf, jnp.asarray(INTR), jc, OK_MIN, MAX_DEPTH)
    return np.asarray(packed), p2


# a triangulated point's DLT eigenvector moves by ~|dM| / gap, where gap is
# the relative gap between its normal matrix's two smallest eigenvalues
# (ops/cuda/triangulate.eigen_gap): small under little parallax, as for
# points near the focus of expansion of this forward motion. The two
# packages' poses part by ~1e-5 before a triangulation, and their points'
# relative difference times the gap stays within ~4e-6 here (every frame
# promoted: 0.12 at gap 2.9e-5, 7.7e-3 at 4.4e-4). Points are compared at
# gaps of at least GAP_POINTS, where that leaves them within the engine
# tests' POINT_TOL / POINT_RTOL; the gap is computed from the record's
# normalized matches and the relative pose from the previous keyframe (the
# batch's input keyframe, or the frame of the previous record) to the
# promoted frame, as the JAX package reports them.
GAP_POINTS = 1e-3


def _gaps(x1, x2, R1, t1, R2, t2) -> np.ndarray:
    Rr = R2 @ R1.T
    M = tri.normal_matrices(*(torch.tensor(np.asarray(a, np.float64))
                              for a in (Rr, t2 - Rr @ t1, x1, x2)))
    return tri.eigen_gap(M.numpy())


# promotions on frames 1, 3 and 5 chain three window BAs, re-refinements
# and triangulations back to back, each on the last one's new landmarks:
# the two libraries' float32 states part further than over the engine
# tests' batch (points up to 1.43x POINT_RTOL apart here), so poses and
# points are held to CHAIN x the engine tests' tolerances
CHAIN = 3.0


def _kf(w):
    return w.tp.kf_R.numpy(), w.tp.kf_t.numpy()


def _persist_close(got: teng.EnginePersist, want, gated, scale=1.0):
    """The engine tests' persist comparison, but for the landmarks of the
    batch's points below GAP_POINTS (`gated`: their local-map slots and JAX
    positions), in the local map and in the loop database's snapshots."""
    slots, points = gated
    want = _np(want)
    for name in teng.EnginePersist._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        elif name in ("lm_X", "db_lmw"):
            keep = ~(w[..., None, :] == points).all(-1).any(-1)
            if name == "lm_X":
                keep[slots] = False
            _close(g[keep], w[keep], scale * POINT_TOL, name,
                   scale * POINT_RTOL)
        else:
            _close(g, w, scale * POSE_TOL, name)


def _hold_to_jax(got, want, cfg, P, kf, scale=1.0):
    """The engine tests' comparison of two packed buffers (triangulated
    points at gaps >= GAP_POINTS). kf: the input keyframe pose (R, t)."""
    tst, trecs, tdb, ttail = _decode(got, cfg, P)
    jst, jrecs, jdb, jtail = _decode(want, cfg, P)
    np.testing.assert_array_equal(tst[:, 22], jst[:, 22])
    assert tdb == jdb
    np.testing.assert_array_equal(tst[:, :2], jst[:, :2])
    _close(tst[:, 4:22], jst[:, 4:22], scale * POSE_TOL,
           "poses and velocity")
    assert len(trecs) == len(jrecs)
    compared, slots, points = 0, [], []
    for a, b in zip(trecs, jrecs):
        assert a.frame == b.frame and a.n2d == b.n2d
        for name in ("lm_slot", "lm_kp", "lm_obs", "m_idx_a", "m_idx_b",
                     "tri_good", "tri_slot"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        R2 = jst[a.frame, 4:13].reshape(3, 3)
        near = b.tri_good & (_gaps(b.m_x1, b.m_x2, *kf, R2,
                                   jst[a.frame, 13:16]) >= GAP_POINTS)
        kf = R2, jst[a.frame, 13:16]
        compared += int(near.sum())
        slots.append(b.tri_slot[b.tri_good & ~near])
        points.append(b.tri_X[b.tri_good & ~near])
        _close(a.tri_X[near], b.tri_X[near], scale * POINT_TOL,
               "triangulated points", scale * POINT_RTOL)
        np.testing.assert_array_equal(a.loop[:, LOOP_INT],
                                      b.loop[:, LOOP_INT])
    assert compared > 0
    _close(ttail.win_R, jtail.win_R, scale * POSE_TOL)
    _close(ttail.win_t, jtail.win_t, scale * POSE_TOL)
    np.testing.assert_array_equal(ttail.win_fid, jtail.win_fid)
    np.testing.assert_array_equal(ttail.lm_valid, jtail.lm_valid)
    return tst, trecs, (np.concatenate(slots), np.concatenate(points))


def test_split_body_with_inactive_frames_matches_jax(world):  # noqa: F811
    """Frames 0 and B-1 inactive: they keep the input / final pose with
    zero stats, as the JAX package's masked scan steps; the active ones
    agree with the JAX package."""
    start, stop = 1, B - 1
    want, jp2 = _jax_batch(world, world.jcfg, start, stop)
    drv = _static_driver(world, world.cfg)
    got, p2 = drv.run(world.tp, _tdyn(start, stop, world), world.tf,
                      torch.tensor(INTR))
    eager, e2 = teng.run_engine_batch(world.tp, _tdyn(start, stop, world),
                                      world.tf, torch.tensor(INTR),
                                      world.cfg, OK_MIN, MAX_DEPTH)
    assert torch.equal(got, eager)
    _equal(p2, e2, "inactive frames")
    tst, _, gated = _hold_to_jax(got, want, world.cfg,
                                 B // world.cfg.keyframe_min_gap, _kf(world))
    assert not tst[[0, B - 1], :4].any() and not tst[[0, B - 1], 22].any()
    np.testing.assert_array_equal(tst[0, 4:13],
                                  world.tp.R.reshape(-1).numpy())
    np.testing.assert_array_equal(tst[B - 1, 4:22], tst[B - 2, 4:22])
    _persist_close(p2, jp2, gated)


def test_split_body_promotions_fill_every_record(world):  # noqa: F811
    """keyframe_min_inliers out of reach and a gap of 2: every second
    tracked frame asks for a promotion and prom_n reaches P = B / 2; the
    records fill all P rows in the JAX package's order."""
    jc, cfg = (c.replace(keyframe_min_inliers=10 ** 6, keyframe_min_gap=2)
               for c in (world.jcfg, world.cfg))
    want, jp2 = _jax_batch(world, jc, 0, B)
    drv = _static_driver(world, cfg)
    got, p2 = drv.run(world.tp, _tdyn(0, B, world), world.tf,
                      torch.tensor(INTR))
    P = teng.promotions_cap(B, cfg)
    tst, recs, gated = _hold_to_jax(got, want, cfg, P, _kf(world), CHAIN)
    assert P == B // 2 and int(got[B * 24]) == P and len(recs) == P
    assert [r.frame for r in recs] == [1, 3, 5]
    assert int(drv.carry.prom_n) == P
    _persist_close(p2, jp2, gated, CHAIN)

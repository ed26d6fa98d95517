"""The port's engine batch program (slam/engine.py) against the JAX package,
unit by unit, from identical state: a synthetic scene of known points seen
from known poses (tests/test_torch_tracking.Scene), two keyframes in a map
filled by the same calls in both packages, and the JAX state handed to the
port through utils/convert.from_numpy(..., device="cpu"). The JAX side runs
as its own tests run it: jitted on the CPU. Each test of the batch runs
twice: with the matcher on the streaming 2-NN (match.impl="pallas", Pallas
in interpret mode) and on FAST_CONFIG's own dense matcher ("xla")."""

import inspect
from types import SimpleNamespace

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from test_torch_tracking import INTR, K, Scene, _state
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.slam import engine as jeng
from visualslam_tpu.slam import map_state as jms
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.models.types import Features
from visualslam_tpu_torch.slam import engine as teng
from visualslam_tpu_torch.slam import map_state as tms
from visualslam_tpu_torch.slam import track_step as tts
from visualslam_tpu_torch.slam import window as twin
from visualslam_tpu_torch.utils import convert
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.convert import from_numpy

W = 4                       # window cameras
CAP = 8                     # loop-database entries
KS = 64                     # loop subsample
B = 6                       # frames 3..8 as one batch
OK_MIN = 10
MAX_DEPTH = 200.0


def configs(impl):
    """(JAX config, port config) at the tests' sizes with the matcher on
    `impl`: "pallas" (the streaming 2-NN) or "xla" (FAST_CONFIG's own)."""
    j = jcfg.FAST_CONFIG.replace(
        match=jcfg.FAST_CONFIG.match.replace(impl=impl, tile=128,
                                             max_matches=128),
        loop=jcfg.FAST_CONFIG.loop.replace(db_capacity=CAP, sub_keypoints=KS,
                                           exclude_recent=1),
        ba=jcfg.FAST_CONFIG.ba.replace(max_cameras=W),
        local_map_size=K, keyframe_min_gap=1, keyframe_max_gap=3)
    return j, SlamConfig.from_json(j.to_json())


# float32 LM / Schur solves in two libraries on the same matches: poses
# agree to ~1e-5 after one solve; chained over a batch with two promotions
# (window BA, re-refine, triangulation) to ~1e-4
POSE_TOL = 1e-4
# triangulated points: eigh on each side agrees to a relative ~1e-4 in the
# eigenvector, which depth / baseline (up to ~30 here) amplifies
POINT_TOL = 2e-3
POINT_RTOL = 5e-3
# integer fields of a loop row: candidate, usable matches, inliers, pairs
# with 3D on both sides, reciprocal inliers
LOOP_INT = [0, 2, 3, 17, 18]


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _port(cls, jtree):
    return from_numpy(cls, _np(jtree), device="cpu")


def _close(got, want, atol, what="", rtol=0.0):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=what)


def _assert_persist_close(got: teng.EnginePersist, want, atol=POSE_TOL):
    want = _np(want)
    for name in teng.EnginePersist._fields:
        g = getattr(got, name).numpy()
        w = np.asarray(getattr(want, name))
        assert g.shape == w.shape, name
        if g.dtype == bool or np.issubdtype(g.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=name)
        else:
            if name in ("lm_X", "db_lmw"):
                _close(g, w, POINT_TOL, name, POINT_RTOL)
            else:
                _close(g, w, atol, name)


def _features(scene, k, r):
    """numpy Keypoints fields + descriptors of view k, with responses
    quantized to 1/8 (ties exercise the top-k order), and the point index
    of each valid slot."""
    kps, desc, idx = scene.features(k)
    resp = np.zeros(K, np.float32)
    resp[:len(idx)] = np.round(r.random(len(idx)) * 8) / 8
    kps = kps[:6] + (resp, kps[7])
    return kps, desc, idx


def _normalized(yx):
    return np.stack([(yx[:, 1] - INTR[2]) / INTR[0],
                     (yx[:, 0] - INTR[3]) / INTR[1]], -1).astype(np.float32)


def _fill_map(ms, scene, views, X_map):
    """Keyframes 0 and 2 at their true poses; two of every three visible
    points become landmarks (the rest stay fresh for triangulation)."""
    m = ms.SlamMap(window=W, max_landmarks=400, feat_capacity=K)
    lm_of = {}
    for k in (0, 2):
        kps, desc, idx = views[k]
        R, t = scene.pose(k)
        slot, _ = m.allocate_keyframe()
        m.set_keyframe(slot, k, R, t, desc, kps[0], kps[7])
        new = [p for p in idx if p % 3 and p not in lm_of]
        for p, g in zip(new, m.allocate_landmarks(X_map[new])):
            lm_of[p] = int(g)
        kp = np.array([j for j, p in enumerate(idx) if p in lm_of])
        lm = np.array([lm_of[idx[j]] for j in kp])
        m.add_observations(slot, lm, _normalized(kps[0][kp]))
        m.kf_kp_lm[slot][kp] = lm
    return m


def _db_entries(r):
    """LoopCloser-style entries: two with data (one shorter than KS), one
    device-resident entry without."""
    out = []
    for n in (KS, KS // 2):
        g = r.standard_normal(128).astype(np.float32)
        out.append(SimpleNamespace(
            global_desc=g / np.linalg.norm(g),
            desc=r.standard_normal((n, 128)).astype(np.float32),
            yx=(r.random((n, 2)) * [240, 376]).astype(np.float32),
            lm_world=r.uniform(-5, 5, (n, 3)).astype(np.float32),
            has_lm=r.random(n) > 0.3,
            R=np.eye(3, dtype=np.float32),
            t=r.standard_normal(3).astype(np.float32)))
    out.append(SimpleNamespace(desc=None))
    return out


@pytest.fixture(scope="module", params=["pallas", "xla"])
def world(request):
    jc, tc = configs(request.param)
    scene = Scene(seed=3)
    r = np.random.default_rng(4)
    views = {k: _features(scene, k, r) for k in range(0, 3 + B)}
    X_map = (scene.X + r.normal(0, 0.01, scene.X.shape)).astype(np.float32)
    maps = (_fill_map(jms, scene, views, X_map),
            _fill_map(tms, scene, views, X_map))
    R, t, vel = _state(scene, 3)
    entries = _db_entries(r)
    jp, jids, jn = jeng.build_persist_from_host(
        maps[0], jc, R, t, vel, 0, db_entries=entries)
    tp, tids, tn = teng.build_persist_from_host(
        maps[1], tc, R, t, vel, 0, db_entries=entries, device="cpu")

    frames = [views[k] for k in range(3, 3 + B)]
    kps = tuple(np.stack([v[0][i] for v in frames]) for i in range(8))
    desc = np.stack([v[1] for v in frames])
    jf = JFeatures(JKeypoints(*(jnp.asarray(a) for a in kps)),
                   jnp.asarray(desc))
    tf = from_numpy(Features, (kps, desc), device="cpu")
    # kill five slots at their generation and spare one whose generation
    # moved on
    kill = np.zeros(K, bool)
    kill[[0, 1, 2, 3, 4, 5]] = True
    kill_gen = np.zeros(K, np.int32)
    kill_gen[5] = 1
    jdyn = jeng.EngineDyn(frame_base=jnp.int32(3), start=jnp.int32(0),
                          stop=jnp.int32(B), kill=jnp.asarray(kill),
                          kill_gen=jnp.asarray(kill_gen))
    tdyn = teng.EngineDyn(frame_base=3, start=0, stop=B,
                          kill=torch.from_numpy(kill),
                          kill_gen=torch.from_numpy(kill_gen))
    intr = jnp.asarray(INTR)
    jpacked, jp2 = jax.jit(jeng.run_engine_batch, static_argnums=(4, 5, 6))(
        jp, jdyn, jf, intr, jc, OK_MIN, MAX_DEPTH)
    before = [x.clone() for x in tp]
    tpacked, tp2 = teng.run_engine_batch(tp, tdyn, tf, torch.tensor(INTR),
                                         tc, OK_MIN, MAX_DEPTH)
    return SimpleNamespace(
        jcfg=jc, cfg=tc, scene=scene, views=views, maps=maps, R=R, t=t,
        vel=vel,
        entries=entries, jp=jp, jids=jids, jn=jn, tp=tp, tids=tids, tn=tn,
        jf=jf, tf=tf, kill=kill, jpacked=np.asarray(jpacked),
        tpacked=tpacked, jp2=jp2, tp2=tp2, before=before, r=r)


def _decode(packed, cfg):
    P = B // cfg.keyframe_min_gap
    return teng.decode_packed(packed, B, cfg.match.max_matches, P, W, K)


def test_engine_entry_points_default_to_the_card():
    """Entry points that make tensors from numpy default to device="cuda";
    a CPU run passes device="cpu" (read from the signatures, no card
    needed)."""
    for fn in (twin.port_ops, tts.build_local_map, convert.from_numpy,
               teng.build_persist_from_host, teng.engine_dyn):
        assert inspect.signature(fn).parameters["device"].default == "cuda", \
            fn.__name__


def test_float_desc_matches_jax():
    r = np.random.default_rng(0)
    words = r.integers(0, 2 ** 32, (5, 8), dtype=np.uint64).astype(np.uint32)
    got = teng.float_desc(torch.from_numpy(words))
    want = np.asarray(jeng.float_desc(jnp.asarray(words)))
    assert got.dtype == torch.float32 and got.shape == (5, 256)
    np.testing.assert_array_equal(got.numpy(), want)
    # the host convention: little-endian bit order of the bytes
    np.testing.assert_array_equal(
        want, np.unpackbits(words.view(np.uint8), axis=1,
                            bitorder="little").astype(np.float32))
    f = r.standard_normal((4, 128)).astype(np.float32)
    np.testing.assert_array_equal(teng.float_desc(torch.from_numpy(f)).numpy(),
                                  np.asarray(jeng.float_desc(jnp.asarray(f))))
    assert teng.float_desc_dim(8, torch.uint32) == 256
    assert teng.float_desc_dim(128, np.float32) == 128


def test_build_persist_from_host_matches_jax(world):
    np.testing.assert_array_equal(world.tids, world.jids)
    assert world.tn == world.jn == 3
    _assert_persist_close(world.tp, world.jp, atol=0)
    assert int(world.tp.win_n) == 2 and world.tp.obs_ok.sum() > 100
    assert world.tp.db_haslm[:2].any() and not world.tp.db_haslm[2:].any()


def test_build_persist_from_old_persist_matches_jax(world):
    """The database comes from the previous persist, the host count
    resetting its write index."""
    jp, _, jn = jeng.build_persist_from_host(
        world.maps[0], world.jcfg, world.R, world.t, world.vel, 2,
        old_persist=world.jp2, db_count=4)
    tp, _, tn = teng.build_persist_from_host(
        world.maps[1], world.cfg, world.R, world.t, world.vel, 2,
        old_persist=world.tp2, db_count=4, device="cpu")
    assert jn is None and tn is None and int(tp.db_n) == 4
    _assert_persist_close(tp, jp)


def test_run_engine_batch_matches_jax(world):
    jst, jrecs, jdb, jtail = _decode(world.jpacked, world.cfg)
    tst, trecs, tdb, ttail = _decode(world.tpacked, world.cfg)
    assert world.tpacked.dtype == torch.float32
    assert world.tpacked.shape == world.jpacked.shape
    promoted = np.nonzero(tst[:, 22])[0]
    assert len(promoted) >= 1
    np.testing.assert_array_equal(tst[:, 22], jst[:, 22])
    assert tdb == jdb == 3 + len(promoted)
    # inlier counts: the same matches through PnP in two libraries
    np.testing.assert_array_equal(tst[:, :2], jst[:, :2])
    _close(tst[:, 4:22], jst[:, 4:22], POSE_TOL, "poses and velocity")
    assert len(trecs) == len(jrecs)
    for a, b in zip(trecs, jrecs):
        assert a.frame == b.frame and a.n2d == b.n2d
        for name in ("lm_slot", "lm_kp", "lm_obs", "m_idx_a", "m_idx_b",
                     "tri_good", "tri_slot"):
            np.testing.assert_array_equal(getattr(a, name),
                                          getattr(b, name), err_msg=name)
        _close(a.lm_x, b.lm_x, 1e-6)
        _close(a.tri_X[a.tri_good], b.tri_X[b.tri_good], POINT_TOL,
               "triangulated points", POINT_RTOL)
        np.testing.assert_array_equal(a.loop[:, LOOP_INT],
                                      b.loop[:, LOOP_INT])
        _close(a.loop[:, 1], b.loop[:, 1], 1e-5, "similarities")
    _close(ttail.win_R, jtail.win_R, POSE_TOL)
    _close(ttail.win_t, jtail.win_t, POSE_TOL)
    np.testing.assert_array_equal(ttail.win_fid, jtail.win_fid)
    np.testing.assert_array_equal(ttail.lm_valid, jtail.lm_valid)
    assert ttail.ba_cost == pytest.approx(jtail.ba_cost, rel=1e-3)
    _assert_persist_close(world.tp2, world.jp2)


def test_decode_packed_reads_the_ports_buffer_like_jax(world):
    port = _decode(world.tpacked, world.cfg)
    P = B // world.cfg.keyframe_min_gap
    ref = jeng.decode_packed(world.tpacked.numpy(), B,
                             world.cfg.match.max_matches, P, W, K)
    np.testing.assert_array_equal(port[0], ref[0])
    assert port[2] == ref[2] and len(port[1]) == len(ref[1]) >= 1
    for a, b in zip(port[1], ref[1]):
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
    for x, y in zip(port[3], ref[3]):
        np.testing.assert_array_equal(x, y)
    assert len(world.tpacked) == (B * 24 + 2 + P * teng.prom_record_size(
        world.cfg.match.max_matches) + teng.tail_size(W, K))


def test_run_engine_batch_leaves_its_input_alone_and_kills(world):
    for name, a, b in zip(teng.EnginePersist._fields, world.before,
                          world.tp):
        assert torch.equal(a, b), name
    new = world.tp2.lm_gen > 0
    # killed slots are invalid unless re-allocated; the spared one lives
    assert not (world.tp2.lm_valid[:5] & ~new[:5]).any()
    assert bool(world.tp.lm_valid[5]) and bool(world.tp2.lm_valid[5] | new[5])


def test_seen_writes_hit_distinct_slots(world):
    """The tracked-landmark writes of a promotion scatter to the matched
    local-map slots: mutual matching makes them distinct."""
    _, recs, _, _ = _decode(world.tpacked, world.cfg)
    for rec in recs:
        slots = rec.lm_slot[rec.lm_obs]
        assert len(slots) > 20 and len(np.unique(slots)) == len(slots)
        fresh = rec.tri_slot[rec.tri_good]
        assert len(np.unique(fresh)) == len(fresh) and (fresh < K).all()


@pytest.mark.parametrize("fix_gauge_scale", [True, False])
def test_window_ba_matches_jax(world, fix_gauge_scale):
    jc, tc = (c.replace(ba=c.ba.replace(fix_gauge_scale=fix_gauge_scale))
              for c in (world.jcfg, world.cfg))
    want = jax.jit(jeng._window_ba, static_argnums=1)(world.jp2, jc)
    got = teng._window_ba(_port(teng.EnginePersist, world.jp2), tc)
    for g, w, tol in zip(got[:3], want[:3],
                         (POSE_TOL, POSE_TOL, POINT_TOL)):
        _close(g.numpy(), w, tol)
    assert got[3].item() == pytest.approx(float(want[3]), rel=1e-3)
    assert int(world.jp2.win_n) >= 3


def _two_views(world, k_a, k_b, scale):
    """Current view a (landmarks at the true points) and database view b
    (landmarks `scale` x the true points), sub-sampled to KS slots: 48
    points both views see, in a different slot order on each side, then
    points only one side sees; a fifth of the landmarks withheld. numpy."""
    r = np.random.default_rng(k_a + k_b)
    (ka, da, ia), (kb, db, ib) = world.views[k_a], world.views[k_b]
    common = r.permutation(np.intersect1d(ia, ib))[:48]
    out = []
    for kps, desc, idx, s in ((ka, da, ia, 1.0), (kb, db, ib, scale)):
        pos = {p: j for j, p in enumerate(idx)}
        rest = [j for j, p in enumerate(idx) if p not in set(common)]
        take = np.array([pos[p] for p in common]
                        + list(r.permutation(rest)[:KS - len(common)]))
        take = r.permutation(take)
        has = r.random(KS) > 0.2
        X = (world.scene.X[idx[take]] * s).astype(np.float32)
        out += [desc[take], kps[0][take], has, X]
    # the entry's stored pose: view b's, a little off
    R, t = world.scene.pose(k_b)
    R_b = (_exp(np.array([0.01, -0.005, 0.004])) @ R).astype(np.float32)
    t_b = (t + np.array([0.05, -0.02, 0.1])).astype(np.float32)
    return out + [R_b, t_b]


@pytest.mark.parametrize("mutual,estimate_scale", [(True, True),
                                                   (False, False)])
def test_verify_candidate_matches_jax(world, mutual, estimate_scale):
    args = _two_views(world, 8, 4, 1.05)
    R_a, t_a = world.scene.pose(8)
    extra = (R_a, t_a) if mutual else ()
    want = np.asarray(jax.jit(
        jeng._verify_candidate, static_argnums=(11, 12))(
        *(jnp.asarray(a) for a in args), jnp.asarray(INTR),
        jeng._sub_match_cfg(world.jcfg), estimate_scale,
        *(jnp.asarray(a) for a in extra)))
    got = teng._verify_candidate(
        *(torch.tensor(np.asarray(a)) for a in args), torch.tensor(INTR),
        teng._sub_match_cfg(world.cfg), estimate_scale,
        *(torch.tensor(np.asarray(a)) for a in extra)).numpy()
    assert got.shape == want.shape == (20,)
    # usable, inliers, nboth, recip_inl exact; pose, scale and the
    # consistency measures from the same matches through float32 LM
    np.testing.assert_array_equal(got[[0, 1, 15, 16]], want[[0, 1, 15, 16]])
    assert want[1] > 20
    _close(got[2:14], want[2:14], POSE_TOL)
    _close(got[14], want[14], 1e-5)
    _close(got[17:], want[17:], 1e-3)
    if estimate_scale:
        assert want[14] == pytest.approx(1.05, abs=1e-4)
    else:
        assert want[14] == 1.0 and want[16] == 0.0


def test_engine_relocalize_matches_jax(world):
    kps, desc, _ = world.views[8]
    jf = JFeatures(JKeypoints(*(jnp.asarray(a) for a in kps)),
                   jnp.asarray(desc))
    tf = from_numpy(Features, (kps, desc), device="cpu")
    db_n = int(world.jp2.db_n)
    want = np.asarray(jax.jit(jeng.engine_relocalize, static_argnums=4)(
        world.jp2, jnp.int32(db_n), jf, jnp.asarray(INTR), world.jcfg))
    got = teng.engine_relocalize(_port(teng.EnginePersist, world.jp2),
                                 db_n, tf, torch.tensor(INTR),
                                 world.cfg).numpy()
    assert got.shape == want.shape == (teng.NC, teng.LOOP_REC)
    np.testing.assert_array_equal(got[:, LOOP_INT], want[:, LOOP_INT])
    _close(got[:, 1], want[:, 1], 1e-5)
    # the entries promoted from frames of this scene relocalize frame 8
    assert want[:, 3].max() > 20
    ok = want[:, 3] > 20
    _close(got[ok, 4:16], want[ok, 4:16], POSE_TOL)


def _exp(w):
    """Rodrigues: rotation of the axis-angle vector w."""
    th = np.linalg.norm(w)
    k = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    return (np.eye(3) + np.sin(th) / th * k
            + (1 - np.cos(th)) / th ** 2 * k @ k)


def _rotations(r, n):
    return np.stack([_exp(w) for w in r.normal(0, 0.05, (n, 3))]).astype(
        np.float32)


def test_apply_correction_matches_jax(world):
    r = np.random.default_rng(8)
    Rg, Rc = _rotations(r, CAP), _rotations(r, CAP)
    tg = r.normal(0, 0.3, (CAP, 3)).astype(np.float32)
    tc = r.normal(0, 0.3, (CAP, 3)).astype(np.float32)
    sg = r.uniform(0.9, 1.1, CAP).astype(np.float32)
    Rl = _rotations(r, 1)[0]
    tl = r.normal(0, 0.3, 3).astype(np.float32)
    args = (Rg, tg, sg, Rc, tc, 3, Rl, tl, np.float32(1.07))
    want = jax.jit(jeng.apply_correction)(
        world.jp2, *(jnp.asarray(a) for a in args))
    got = teng.apply_correction(_port(teng.EnginePersist, world.jp2), *args)
    _assert_persist_close(got, want, atol=1e-5)
    moved = np.abs(got.db_R[:3].numpy() - np.asarray(world.jp2.db_R)[:3])
    assert moved.max() > 1e-3
    np.testing.assert_array_equal(got.db_R[3:].numpy(),
                                  np.asarray(world.jp2.db_R)[3:])


@pytest.mark.parametrize("n", [1, CAP])
def test_db_append_host_matches_jax(world, n):
    """Append at ring index n; n = CAP drops the entry but still raises
    db_n, as the reference's mode="drop"."""
    r = np.random.default_rng(n)
    entry = (r.standard_normal(128), r.standard_normal((KS, 128)),
             r.random((KS, 2)) * 100, r.standard_normal((KS, 3)),
             r.random(KS) > 0.5, _rotations(r, 1)[0], r.standard_normal(3))
    entry = tuple(np.asarray(a, np.float32) if a.dtype != bool else a
                  for a in entry)
    want = jax.jit(jeng.db_append_host)(world.jp2, n,
                                        *(jnp.asarray(a) for a in entry))
    base = _port(teng.EnginePersist, world.jp2)
    got = teng.db_append_host(base, n, *entry)
    _assert_persist_close(got, want, atol=0)
    assert int(got.db_n) == max(int(world.jp2.db_n), n + 1)

"""The host-path tracker programs, the loop closer's verify programs, the
engine's database programs and the module-level names that come with
them (`models.matching.match_features_jit`, `backend.pnp.refine_pose_jit`,
`slam.track_step.track_step_jit`), on the CPU.

On the card each replays one captured CUDA graph per shape key
(utils/graphs.GraphProgram); on the CPU each is its eager function. Here:

  * each program's data flow on the captured branch, through a stand-in
    capture (utils.graphs._Capture replaced by one whose graphs run their
    bodies as they are, the programs made to replay), equals its eager
    function bit for bit for two inputs of one key, the first result held
    across the second;
  * match_features_jit, refine_pose_jit, track_step_jit and the loop
    closer's _shared_verifier / _shared_verifier_batch against the JAX
    package's namesakes on the same inputs (Pallas in interpret mode, the
    matcher pinned to "pallas" and to FAST_CONFIG's "xla"), at the
    tolerances of tests/test_torch_tracking.py: match sets equal, ranks
    compared only between neighbours more than RANK_GAP apart (hazard 5),
    poses within POSE_TOL, PnP inlier flags equal off near-ties
    (NEAR_TIE of the threshold);
  * the tracker's `_shared_programs` has the JAX package's keys;
  * the host-path tracker (engine=False: process_batch's track_batch and
    kf_step, process's track_lite, the init's match) on the captured
    branch against the eager tracker, bit for bit, and its second
    process_batch call makes no tensor from host memory inside a program
    body; prewarm_aux prepares the host path's keys;
  * detect verifies a candidate batch padded to top_k (one key for 1-3
    surviving candidates) and takes the JAX package's edge; warm_verify
    prepares the three verify programs at the database's shapes;
  * db_correct / db_append as programs, and db_append_host with a device
    index (the drop at n >= CAP included)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_loop_closure as lct
from test_torch_frontend_program import _StandInCapture
from test_torch_tracking import (
    DENSE_POSE_TOL,
    INTR,
    K,
    OK_MIN,
    POSE_TOL,
    Scene,
    _assert_ranked_alike,
    _both,
    _fill_map,
    _kf_ref,
    _np,
    _state,
    configs,
)
from tracker_scene import CFG as SCENE_CFG
from tracker_scene import INTR as SCENE_INTR
from tracker_scene import SyntheticScene
from visualslam_tpu.backend import pnp as jpnp
from visualslam_tpu.models import matching as jm
from visualslam_tpu.slam import loop_closure as jlc
from visualslam_tpu.slam import track_step as jts
from visualslam_tpu.slam import tracker as jtr
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.backend import pnp as tpnp
from visualslam_tpu_torch.models import matching as tm
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import KERNELS
from visualslam_tpu_torch.slam import engine as teng
from visualslam_tpu_torch.slam import loop_closure as tlc
from visualslam_tpu_torch.slam import map_state as tms
from visualslam_tpu_torch.slam import track_step as tts
from visualslam_tpu_torch.slam import tracker as ttr
from visualslam_tpu_torch.utils import graphs
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.convert import from_numpy

MAX_DEPTH = 200.0
# refine_pose_jit and the verifiers' LM against the JAX package's from a
# start 0.2 away: float32 sums in another order over ten damped steps
# leave the poses up to 2.8e-5 apart (measured); held to 1e-4
PNP_POSE_TOL = 1e-4
LM_ITERS = (10, 5e-3, 6e-3, 1e-4)   # refine_pose's defaults
# PnP inlier flags may part only where a point's reprojection error lies
# within this much of the inlier threshold under either package's pose
# (poses agree to POSE_TOL / DENSE_POSE_TOL; at depths 10..40 that moves
# a normalized coordinate by ~1e-5)
NEAR_TIE = 1e-4
SUB = 128                           # the loop closer's sub_keypoints here


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


MODULE_PROGRAMS = (tm.match_features_jit.program,
                   tpnp.refine_pose_jit.program,
                   tts.track_step_jit.program)
SHARED = (ttr._shared_programs, tlc._shared_matcher, tlc._shared_verifier,
          tlc._shared_verifier_batch, teng.engine_programs)


def _forget():
    for prog in MODULE_PROGRAMS:
        prog.captured.clear()
    for cache in SHARED:
        cache.cache_clear()


@pytest.fixture()
def captured(monkeypatch):
    """The captured branch's data flow on the CPU: a stand-in capture and
    every GraphProgram made to replay; programs start and end empty."""
    _forget()
    monkeypatch.setattr(graphs, "_Capture", _StandInCapture)
    monkeypatch.setattr(graphs.GraphProgram, "_replays",
                        lambda self, x, cfg: True)
    yield
    _forget()


def _equal(a, b) -> bool:
    la, lb = graphs._leaves(a), graphs._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


@pytest.fixture(scope="module")
def scene():
    return Scene()


@pytest.fixture(scope="module", params=["pallas", "xla"])
def cfgs(request):
    return configs(request.param)


def _feats(scene, k) -> Features:
    kps, desc, _ = scene.features(k)
    return _both(kps, desc)[1]


def _batch(scene, ks) -> Features:
    views = [scene.features(k) for k in ks]
    kps = tuple(np.stack([v[0][i] for v in views]) for i in range(8))
    return _both(kps, np.stack([v[1] for v in views]))[1]


def _pnp_inputs(scene, k, seed):
    """refine_pose's (R0, t0, X, uv, valid) for view k: noisy projections
    with 20 outliers and a perturbed start (test_torch_tracking's)."""
    r = np.random.default_rng(seed)
    R, t = scene.pose(k)
    Xc = scene.X @ R.T + t
    uv = (Xc[:, :2] / Xc[:, 2:] + r.normal(0, 1e-3, (len(Xc), 2))).astype(
        np.float32)
    uv[:20] += 0.05
    valid = np.arange(len(Xc)) < len(Xc) - 10
    w = np.array([0.01, -0.02, 0.005], np.float32)
    th = np.linalg.norm(w)
    Kx = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    dR = (np.eye(3) + np.sin(th) / th * Kx
          + (1 - np.cos(th)) / th ** 2 * Kx @ Kx).astype(np.float32)
    return (dR @ R, (dR @ t + np.array([0.1, -0.05, 0.2])).astype(
        np.float32), scene.X, uv, valid)


def _verify_inputs(scene, a, bs, seed=3):
    """A loop closer's verify inputs: entry a's landmark side (its
    descriptors, keypoints, a landmark on two thirds of them and their
    points) and, per view b of bs, the camera's side (descriptors,
    keypoints, a start pose near the truth, drawn per view: a repeated
    view repeats its inputs, as detect's padding does). numpy, in the
    programs' argument order, the cameras' stacked (_shared_verifier_batch's;
    `_single` gives _shared_verifier's)."""
    r = np.random.default_rng(seed)
    kps, desc, idx = scene.features(a)
    n = len(idx)
    has_lm = np.arange(K) < (2 * n) // 3
    lmw = np.zeros((K, 3), np.float32)
    lmw[:n] = scene.X[idx] + r.normal(0, 0.01, (n, 3))
    views = {}
    for b in bs:
        if b not in views:
            kb, db, _ = scene.features(b)       # draws the view's noise
            R, t = scene.pose(b)
            dt = r.normal(0, 0.05, 3)
            views[b] = (db, kb[0], R, (t + dt).astype(np.float32))
    side = [views[b] for b in bs]
    cams = tuple(np.stack(f) for f in zip(*side))
    return (desc, kps[0], has_lm, lmw) + cams + (INTR,)


def _single(x):
    """The first candidate of stacked verify inputs."""
    return x[:4] + tuple(a[0] for a in x[4:8]) + x[8:]


def _torch(x):
    return tuple(torch.from_numpy(np.ascontiguousarray(a)) for a in x)


def _loop_match_cfg(cfg):
    return cfg.match.replace(max_matches=SUB, metric="l2")


_INPUTS: dict = {}


def _inputs(scene, cfg) -> dict:
    """The cases' tensors for cfg's matcher, made once per module."""
    key = cfg.match.impl
    if key not in _INPUTS:
        intr = torch.tensor(INTR)
        lmap = from_numpy(tts.LocalMap, scene.local_map(), device="cpu")
        st = [from_numpy(tts.TrackState, _state(scene, k), device="cpu")
              for k in (5, 6)]
        fb = _batch(scene, range(3, 8))
        _INPUTS[key] = dict(
            intr=intr, lmap=lmap, st=st, fb=fb,
            kf=from_numpy(tts.KeyframeRef, _kf_ref(scene, 2), device="cpu"),
            pairs=[(_feats(scene, 5), _feats(scene, 6)),
                   (_feats(scene, 6), _feats(scene, 7))],
            bl=tts.track_batch(lmap, fb, 2, st[0], intr, cfg, OK_MIN)[1],
            feats=[_feats(scene, k) for k in (5, 6)],
            pnp=[_torch(_pnp_inputs(scene, k, k)) for k in (3, 4)],
            vb=[_torch(_verify_inputs(scene, 2, bs))
                for bs in ((4, 5, 4), (5, 6, 5))])
    return _INPUTS[key]


def _cases(scene, cfg) -> dict:
    """name -> (program, cfg, two inputs of one key, the eager function of
    an input) for every new program."""
    d = _inputs(scene, cfg)
    intr, lmap, st, kf, pairs, fb, bl, vb = (
        d[k] for k in ("intr", "lmap", "st", "kf", "pairs", "fb", "bl",
                       "vb"))
    progs = ttr._shared_programs(cfg)
    mcfg = (cfg.match, KERNELS)
    lite_cfg = ((cfg, OK_MIN), KERNELS)
    kf_cfg = ((cfg, MAX_DEPTH), KERNELS)
    i32 = torch.int32

    def kf_step(x):
        kf_, fb_, i, bl_, intr_ = x
        f = tts.index_features(fb_, int(i))
        full = tts.keyframe_step(kf_, f, tts.lite_at(bl_, int(i)), intr_,
                                 cfg, MAX_DEPTH)
        return tts.pack_keyframe_products(full, f), f

    vcfg = (_loop_match_cfg(cfg), KERNELS)
    return {
        "match_features_jit": (
            tm.match_features_jit.program, mcfg, pairs,
            lambda x: tm.match_features(*x, cfg.match)),
        "tracker.match": (progs["match"], mcfg, pairs,
                          lambda x: tm.match_features(*x, cfg.match)),
        "refine_pose_jit": (
            tpnp.refine_pose_jit.program, (LM_ITERS, KERNELS),
            d["pnp"],
            lambda x: tpnp.refine_pose(*x)),
        "track_step_jit": (
            tts.track_step_jit.program, ((cfg, OK_MIN, MAX_DEPTH), KERNELS),
            [(kf, lmap, f, s, intr) for f, s in zip(d["feats"], st)],
            lambda x: tts.track_step(*x, cfg, OK_MIN, MAX_DEPTH)),
        "tracker.track_lite": (
            progs["track_lite"], lite_cfg,
            [(lmap, fb, torch.tensor(i, dtype=i32), st[0], intr)
             for i in (2, 3)],
            lambda x: tts.track_step_lite(
                x[0], tts.index_features(x[1], int(x[2])), *x[3:], cfg,
                OK_MIN)),
        "tracker.track_batch": (
            progs["track_batch"], lite_cfg,
            [(lmap, fb, torch.tensor(s, dtype=i32), st[j], intr)
             for j, s in enumerate((2, 0))],
            lambda x: tts.track_batch(x[0], x[1], int(x[2]), *x[3:], cfg,
                                      OK_MIN)),
        "tracker.kf_step": (
            progs["kf_step"], kf_cfg,
            [(kf, fb, torch.tensor(i, dtype=i32), bl, intr) for i in (2, 4)],
            kf_step),
        "tracker.stack_stats": (
            progs["stack_stats"], mcfg,
            [tuple(bl.stats[k] for k in o) for o in ((2, 3, 4), (4, 2, 3))],
            lambda x: torch.stack(x)),
        "loop.matcher": (
            tlc._shared_matcher(*vcfg), vcfg, pairs,
            lambda x: tm.match_features(*x, vcfg[0])),
        "loop.verifier": (
            tlc._shared_verifier(*vcfg), vcfg, [_single(x) for x in vb],
            lambda x: tlc._verify(*x, *vcfg)),
        "loop.verifier_batch": (
            tlc._shared_verifier_batch(*vcfg), vcfg, vb,
            lambda x: torch.stack([
                tlc._verify(*x[:4], *(a[c] for a in x[4:8]), x[8], *vcfg)
                for c in range(3)])),
    }


CASES = ("match_features_jit", "tracker.match", "refine_pose_jit",
         "track_step_jit", "tracker.track_lite", "tracker.track_batch",
         "tracker.kf_step", "tracker.stack_stats", "loop.matcher",
         "loop.verifier", "loop.verifier_batch")


@pytest.mark.parametrize("case", CASES)
def test_program_on_the_captured_branch_equals_its_eager_function(
        captured, scene, cfgs, case):
    """The program replays (the stand-in capture) two inputs of one key:
    each result equals the eager function bit for bit, the first still
    does after the second ran, and one key was captured."""
    _, cfg = cfgs
    prog, pcfg, xs, eager = _cases(scene, cfg)[case]
    want = [eager(x) for x in xs]
    got = [prog(x, pcfg) for x in xs]
    for g, w in zip(got, want):
        assert _equal(g, w)
    assert not _equal(got[0], got[1])
    assert _equal(got[0], eager(xs[0]))
    assert len(prog.captured) == 1


@pytest.mark.parametrize("case", CASES)
def test_program_on_the_cpu_is_its_eager_function(scene, case):
    """Off the card nothing is captured: the program is its function."""
    _forget()
    _, cfg = configs("pallas")
    prog, pcfg, xs, eager = _cases(scene, cfg)[case]
    assert _equal(prog(xs[0], pcfg), eager(xs[0]))
    assert not prog.captured


def test_public_names_call_their_programs(captured, scene):
    """match_features_jit, refine_pose_jit and track_step_jit take the JAX
    package's arguments and replay their programs."""
    _, cfg = configs("pallas")
    fa, fb = _feats(scene, 5), _feats(scene, 6)
    assert _equal(tm.match_features_jit(fa, fb, cfg.match),
                  tm.match_features(fa, fb, cfg.match))
    x = _torch(_pnp_inputs(scene, 3, 0))
    assert _equal(tpnp.refine_pose_jit(*x, 8), tpnp.refine_pose(*x, 8))
    args = (from_numpy(tts.KeyframeRef, _kf_ref(scene, 2), device="cpu"),
            from_numpy(tts.LocalMap, scene.local_map(), device="cpu"), fb,
            from_numpy(tts.TrackState, _state(scene, 6), device="cpu"),
            torch.tensor(INTR))
    assert _equal(tts.track_step_jit(*args, cfg, OK_MIN, MAX_DEPTH),
                  tts.track_step(*args, cfg, OK_MIN, MAX_DEPTH))
    assert [len(p.captured) for p in MODULE_PROGRAMS] == [1, 1, 1]


def test_tensor_frame_index_equals_the_int_index(scene):
    """index_features / lite_at with a 0-d tensor (index_select copies;
    ORB's uint32 descriptors through an int32 view) equal the int index's
    views."""
    fb = _batch(scene, range(3, 6))
    for i in range(3):
        assert _equal(tts.index_features(fb, torch.tensor(i)),
                      tts.index_features(fb, i))
    bits = fb._replace(descriptors=torch.arange(
        3 * K * 8, dtype=torch.int64).reshape(3, K, 8).to(torch.uint32))
    got = tts.index_features(bits, torch.tensor(1, dtype=torch.int32))
    assert got.descriptors.dtype == torch.uint32
    assert _equal(got, tts.index_features(bits, 1))


# --- against the JAX package's namesakes ---------------------------------


def test_match_features_jit_matches_jax(scene, cfgs):
    jc, cfg = cfgs
    kps, desc, _ = scene.features(5)
    kb, db, _ = scene.features(6)
    (ja, ta), (jb, tb) = _both(kps, desc), _both(kb, db)
    want = _np(jm.match_features_jit(ja, jb, jc.match))
    got = tm.match_features_jit(ta, tb, cfg.match)
    assert int(got.count()) == int(want.valid.sum()) > 100
    fields = ("idx_a", "idx_b", "valid")
    if cfg.match.impl == "pallas":
        for n in fields:
            np.testing.assert_array_equal(getattr(got, n).numpy(),
                                          getattr(want, n), err_msg=n)
    else:
        _assert_ranked_alike([getattr(got, n).numpy() for n in fields],
                             [getattr(want, n) for n in fields], desc, db)
    np.testing.assert_allclose(np.sort(got.distance.numpy()),
                               np.sort(want.distance), rtol=1e-5, atol=1e-6)


def test_refine_pose_jit_matches_jax(scene):
    args = _pnp_inputs(scene, 3, 0)
    want = jpnp.refine_pose_jit(*(jnp.asarray(a) for a in args))
    got = tpnp.refine_pose_jit(*_torch(args))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R),
                               atol=PNP_POSE_TOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t),
                               atol=PNP_POSE_TOL)
    np.testing.assert_array_equal(got.inliers.numpy(),
                                  np.asarray(want.inliers))
    assert int(got.num_inliers) == int(want.num_inliers) > 100


def test_track_step_jit_matches_jax(scene, cfgs):
    """Local-map and 2D-2D matches as sets (ranks by RANK_GAP under the
    dense matcher), the pose within tolerance, the triangulated points
    as tests/test_torch_tracking.py holds keyframe_step."""
    jc, cfg = cfgs
    kps, desc, _ = scene.features(6)
    jf, tf = _both(kps, desc)
    lm, ref, st = scene.local_map(), _kf_ref(scene, 2), _state(scene, 6)
    want = _np(jts.track_step_jit(
        jts.KeyframeRef(*(jnp.asarray(a) for a in ref)),
        jts.LocalMap(*(jnp.asarray(a) for a in lm)), jf,
        jts.TrackState(*(jnp.asarray(a) for a in st)), jnp.asarray(INTR),
        jc, OK_MIN, MAX_DEPTH))
    got = tts.track_step_jit(
        from_numpy(tts.KeyframeRef, ref, device="cpu"),
        from_numpy(tts.LocalMap, lm, device="cpu"), tf,
        from_numpy(tts.TrackState, st, device="cpu"), torch.tensor(INTR),
        cfg, OK_MIN, MAX_DEPTH)
    ai = got.assoc_i.numpy()
    if cfg.match.impl == "pallas":
        np.testing.assert_array_equal(ai, want.assoc_i)
        tol = POSE_TOL
    else:
        # the local-map part (slot, keypoint, flags) and the 2D-2D part
        # (keyframe keypoint, keypoint, flags)
        for cols, a_desc in (((0, 1, 2), lm[0]), ((3, 4, 5), ref[0])):
            _assert_ranked_alike([ai[:, c] for c in cols],
                                 [want.assoc_i[:, c] for c in cols], a_desc,
                                 desc)
        tol = DENSE_POSE_TOL
    for n in ("R", "t", "vel"):
        np.testing.assert_allclose(getattr(got, n).numpy(),
                                   getattr(want, n), atol=tol, err_msg=n)
    np.testing.assert_allclose(got.stats.numpy(), want.stats, rtol=1e-4,
                               atol=tol)
    assert want.stats[1] > 100


def _pnp_errors(x, R, t, ia, ib):
    """Reprojection error of each match slot's landmark under (R, t)."""
    lmw, yx_b = x[3], x[5]
    Xc = lmw[ia] @ R.T + t
    uv = Xc[:, :2] / np.maximum(Xc[:, 2:], 1e-6)
    obs = (yx_b[ib][:, ::-1] - INTR[2:]) / INTR[:2]
    return np.linalg.norm(uv - obs, axis=1)


def _assert_verify_alike(got: np.ndarray, want: np.ndarray, x, M: int,
                         tol: float) -> None:
    """One packed verification against the reference's: the same usable
    matches (as sets; ranks by RANK_GAP), the pose within tol, the PnP
    inlier flags equal but at near-ties of the threshold, the counts apart
    by at most the near-ties."""
    g = tlc._unpack_verify(got, M)
    w = tlc._unpack_verify(want, M)
    n_g, R_g, t_g, use_g, ia_g, ib_g, inl_g = g
    n_w, R_w, t_w, use_w, ia_w, ib_w, inl_w = w
    _assert_ranked_alike([ia_g, ib_g, use_g], [ia_w, ib_w, use_w], x[0],
                         x[4])
    np.testing.assert_allclose(R_g, R_w, atol=tol)
    np.testing.assert_allclose(t_g, t_w, atol=tol)
    near = np.zeros(M, bool)
    for R, t in ((R_g, t_g), (R_w, t_w)):
        near |= np.abs(_pnp_errors(x, R, t, ia_w, ib_w) - 6e-3) < NEAR_TIE
    # the same match in both, looked up by (idx_a, idx_b)
    key_g = {(a, b): f for a, b, f in zip(ia_g, ib_g, inl_g)}
    for a, b, f, nt in zip(ia_w, ib_w, inl_w, near):
        if not nt:
            assert key_g[(a, b)] == f
    assert abs(n_g - n_w) <= near.sum() and n_w >= 25


def test_verifiers_match_jax(scene, cfgs):
    """_shared_verifier and _shared_verifier_batch (three candidates, the
    last a repeat of the first, as detect pads) against the JAX package's
    on the same entry and cameras."""
    jc, cfg = cfgs
    x = _verify_inputs(scene, 2, (4, 5, 4))
    jcf = jc.match.replace(max_matches=SUB, metric="l2")
    pcf = _loop_match_cfg(cfg)
    want_b = np.asarray(jlc._shared_verifier_batch(jcf)(
        *(jnp.asarray(a) for a in x)))
    got_b = tlc._shared_verifier_batch(pcf, KERNELS)(_torch(x),
                                                     (pcf, KERNELS)).numpy()
    one = _single(x)
    want = np.asarray(jlc._shared_verifier(jcf)(*(jnp.asarray(a)
                                                  for a in one)))
    got = tlc._shared_verifier(pcf, KERNELS)(_torch(one),
                                             (pcf, KERNELS)).numpy()
    tol = PNP_POSE_TOL
    _assert_verify_alike(got, want, one, SUB, tol)
    for c in range(3):
        xc = x[:4] + tuple(a[c] for a in x[4:8]) + x[8:]
        _assert_verify_alike(got_b[c], want_b[c], xc, SUB, tol)
    np.testing.assert_array_equal(got_b[0], got_b[2])
    np.testing.assert_array_equal(got_b[0], got)


# --- the tracker's programs ----------------------------------------------


def test_shared_programs_have_the_jax_keys():
    """The port's _shared_programs(cfg) has the JAX package's eight keys,
    each a GraphProgram, shared per config."""
    _, cfg = configs("pallas")
    jc = jcfg.SlamConfig.from_json(cfg.to_json())
    progs = ttr._shared_programs(cfg)
    assert set(progs) == set(jtr._shared_programs(jc, OK_MIN, MAX_DEPTH))
    assert set(progs) == {"frontend", "frontend_batched", "match", "ransac",
                          "track_lite", "track_batch", "kf_step",
                          "stack_stats"}
    assert all(isinstance(p, graphs.GraphProgram) for p in progs.values())
    assert ttr._shared_programs(cfg) is progs
    assert progs["track_lite"] is not progs["track_batch"]


# the host-path tracker on the injected-feature scene of tests/tracker_scene
HOST_FRAMES = 26
HOST_CFG = SlamConfig.from_json(SCENE_CFG.to_json()).replace(
    keyframe_max_gap=3)


class _Scene:
    """Port Features of the scene's frames, batched by frame id: the
    tracker's detection is replaced by these (detect_batch(ids))."""

    def __init__(self):
        scene = SyntheticScene(np.random.default_rng(5), n_points=700,
                               max_depth=60.0)
        self.views = [scene.features(k)[0] for k in range(HOST_FRAMES)]

    def detect(self, ids) -> Features:
        vs = [self.views[int(k)] for k in np.asarray(ids).reshape(-1)]
        yx, desc, valid = (np.stack(a) for a in zip(*vs))
        empty = Keypoints.empty(yx.shape[1])
        kps = Keypoints(*(f[None].expand(len(vs), *f.shape).clone()
                          for f in empty))
        kps = kps._replace(yx=torch.tensor(yx), valid=torch.tensor(valid))
        return Features(kps, torch.tensor(desc))


def _host_run(scene: _Scene, watch=None):
    """process_batch over frames 0..7, 8..15 and 16..23 (engine=False),
    then frames 24 and 25 one at a time (Tracker.process). watch(k) is
    called before batch k."""
    t = ttr.Tracker(HOST_CFG, SCENE_INTR, engine=False, device="cpu")
    t.detect_batch = scene.detect
    for k, first in enumerate((0, 8, 16)):
        if watch is not None:
            watch(k)
        t.process_batch(np.arange(first, first + 8), first)
    for fid in (24, 25):
        t.process(np.int64(fid), fid)
    return t


@pytest.fixture(scope="module")
def host_runs():
    """The eager host path, then the same on the captured branch (stand-in
    capture, programs made to replay) with the torch.from_numpy / tensor /
    as_tensor calls made inside a program body counted per batch."""
    scene = _Scene()
    _forget()
    eager = _host_run(scene)
    mp = pytest.MonkeyPatch()
    calls: list = []
    inside = [0]
    try:
        _forget()
        mp.setattr(graphs, "_Capture", _StandInCapture)
        mp.setattr(graphs.GraphProgram, "_replays",
                   lambda self, x, cfg: True)
        real_fn = {}
        for name in ("from_numpy", "tensor", "as_tensor"):
            real = getattr(torch, name)

            def counted(*a, _real=real, _name=name, **kw):
                if inside[0]:
                    calls[-1].append(_name)
                return _real(*a, **kw)

            mp.setattr(torch, name, counted)
        progs = ttr._shared_programs(HOST_CFG)
        for prog in progs.values():
            real_fn[prog] = prog.fn

            def body(*a, _fn=prog.fn, **kw):
                inside[0] += 1
                try:
                    return _fn(*a, **kw)
                finally:
                    inside[0] -= 1

            mp.setattr(prog, "fn", body)
        graph = _host_run(scene, watch=lambda k: calls.append([]))
        keys = {n: len(p.captured) for n, p in progs.items()}
        graph.prewarm_aux()
        after = {n: len(p.captured) for n, p in progs.items()}
        lc_keys = [len(p.captured) for p in (graph.loop_closer._match,
                                              graph.loop_closer._verifier,
                                              graph.loop_closer._verifier_batch)]
    finally:
        mp.undo()
        _forget()
    return dict(eager=eager, graph=graph, calls=calls, keys=keys,
                after=after, lc_keys=lc_keys)


def test_host_path_on_the_captured_branch_equals_the_eager_tracker(
        host_runs):
    """Frames, map, loop database and host mirrors bit for bit
    (chip_smoke.state_diffs); the host path promoted keyframes and
    tracked single frames through its programs."""
    import chip_smoke

    a, b = host_runs["eager"], host_runs["graph"]
    assert chip_smoke.state_diffs(a, b) == []
    assert len(b.frames) == HOST_FRAMES
    assert sum(f.is_keyframe for f in b.frames) >= 5
    assert all(f.tracking_ok for f in b.frames)
    keys = host_runs["keys"]
    assert keys["match"] == 1 and keys["ransac"] == 1
    assert keys["track_batch"] == 1 and keys["track_lite"] == 1
    assert keys["kf_step"] >= 1 and keys["frontend"] == 0


def test_second_host_path_batch_makes_no_tensor_from_host_memory(host_runs):
    """Inside the program bodies of the second and third process_batch
    calls (tracking and promotions), no torch.from_numpy / tensor /
    as_tensor: nothing a capture would refuse."""
    calls = host_runs["calls"]
    assert len(calls) == 3
    assert calls[1] == [] and calls[2] == []


def test_prewarm_aux_prepares_the_host_path_keys(host_runs):
    """After the run, prewarm_aux prepares the host path's keys at one
    frame (the stream's batch is unset on process_batch's path): "match",
    "track_lite" and "track_batch" keep the run's one key each, "kf_step"
    holds one at one frame and one at the run's batch of 8; the loop
    closer's verify programs hold one key each, from warm_verify."""
    keys, after = host_runs["keys"], host_runs["after"]
    for name in ("match", "track_lite", "track_batch", "ransac"):
        assert after[name] == keys[name] == 1, name
    assert after["kf_step"] == 2
    assert host_runs["lc_keys"] == [1, 1, 1]


def test_prewarm_aux_captures_the_stream_batch_keys(captured):
    """With the stream's batch known (process_stream on the host path),
    prewarm_aux prepares "track_batch" and "kf_step" at it before any
    batch ran there."""
    scene = _Scene()
    cfg = HOST_CFG.replace(keyframe_max_gap=4)
    t = ttr.Tracker(cfg, SCENE_INTR, engine=False, device="cpu")
    t.detect_batch = scene.detect
    for fid in range(4):
        t.process(np.int64(fid), fid)
    progs = t._progs
    assert not progs["track_batch"].captured
    t._stream_B = 8
    t.prewarm_aux()
    (key, _), = progs["track_batch"].captured.items()
    assert key[0][3][0] == (8, 1024, 2)              # fb's yx
    # kf_step's fb follows the six KeyframeRef leaves
    assert {k[0][6][0][0] for k in progs["kf_step"].captured} == {1, 8}
    assert len(progs["match"].captured) == 1


# --- the loop closer's verify programs ------------------------------------


def test_detect_pads_candidates_to_one_key_and_matches_jax(captured):
    """detect verifies its surviving candidates (1, 2, 3 by the cosine
    gate) through one key of the batch verifier, padded to top_k = 3, and
    takes the JAX package's edge on the same database; relocalize replays
    the single verifier."""
    scene, es = lct.entries()
    jl, pl = lct.closers(False)
    lct.fill((jl, pl), scene, es)
    j = lct.KEYFRAMES - 1
    cur = pl.entries[j]
    n = len(pl.entries)
    sims = np.sort(np.stack([e.global_desc for e in pl.entries[
        : n - pl.exclude - 1]]) @ cur.global_desc)[::-1]
    prog = pl._verifier_batch
    for m in (1, 2, 3):
        pl.cos_thresh = float(sims[m - 1]) - 1e-6 if m < 3 else 0.3
        pl.loop_edges.clear()
        pl.detect(j)
    (key, _), = prog.captured.items()
    assert key[0][4][0] == (3, SUB, 64)              # descs_b
    jl.cos_thresh = pl.cos_thresh = 0.3
    pl.loop_edges.clear()
    ej, ep = jl.detect(j), pl.detect(j)
    assert ej is not None and ep is not None
    assert (ep.i, ep.j) == (ej.i, ej.j) and abs(ep.num_inliers
                                                - ej.num_inliers) <= 2
    np.testing.assert_allclose(ep.R, ej.R, atol=1e-3)
    assert len(prog.captured) == 1
    e = es[j]
    rp = pl.relocalize(lct._feats(e, True))
    rj = jl.relocalize(lct._feats(e, False))
    assert rp is not None and rp[3] == rj[3]
    assert len(pl._verifier.captured) == 1


def test_warm_verify_prepares_the_three_programs(captured):
    """add_keyframe's warm_verify prepares the matcher, the verifier and
    the batch verifier at the database's shapes (sub_keypoints x the
    descriptor width; three candidates), once per closer; detect and
    relocalize then replay those keys."""
    scene, es = lct.entries()
    _, pl = lct.closers(False)
    progs = (pl._match, pl._verifier, pl._verifier_batch)
    pl.add_keyframe(0, es[0]["R"], es[0]["t"], lct._feats(es[0], True),
                    es[0]["lm"], scene.X.astype(np.float32))
    assert [len(p.captured) for p in progs] == [1, 1, 1]
    (key, _), = pl._verifier_batch.captured.items()
    assert key[0][4][0] == (3, SUB, 64) and key[0][0][0] == (SUB, 64)
    before = [list(p.captured) for p in progs]
    X = scene.X.astype(np.float32)
    for k, e in enumerate(es[1:], 1):
        pl.add_keyframe(k, e["R"], e["t"], lct._feats(e, True), e["lm"], X)
    pl.cos_thresh = 0.3
    assert pl.detect(lct.KEYFRAMES - 1) is not None
    assert pl.relocalize(lct._feats(es[-1], True)) is not None
    assert [list(p.captured) for p in progs] == before


# --- the engine's database programs ---------------------------------------


@pytest.fixture(scope="module")
def persist(scene):
    _, cfg = configs("pallas")
    views = [scene.features(k) for k in range(3)]
    m = _fill_map(tms, scene, views)
    R, t = scene.pose(2)
    p, _, _ = teng.build_persist_from_host(m, cfg, R, t,
                                           np.zeros(6, np.float32), 0,
                                           db_capacity=8, device="cpu")
    return cfg, p


def _correction(seed: int, cap: int):
    r = np.random.default_rng(seed)

    def rot(n):
        q = r.standard_normal((n, 4))
        q /= np.linalg.norm(q, axis=1, keepdims=True)
        w, x, y, z = q.T
        return np.stack([
            1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w),
            2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w),
            2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y),
        ], 1).reshape(n, 3, 3).astype(np.float32)

    f = np.float32
    return (rot(cap), r.normal(0, 0.3, (cap, 3)).astype(f),
            r.uniform(0.9, 1.1, cap).astype(f), rot(cap),
            r.normal(0, 0.3, (cap, 3)).astype(f), 3 + seed, rot(1)[0],
            r.normal(0, 0.3, 3).astype(f), f(1.0 + 0.01 * seed))


def _entry(seed: int, ks: int, d: int):
    r = np.random.default_rng(seed)
    f = np.float32
    return (r.standard_normal(d).astype(f),
            r.standard_normal((ks, d)).astype(f),
            (r.random((ks, 2)) * 100).astype(f),
            r.standard_normal((ks, 3)).astype(f), r.random(ks) > 0.5,
            np.eye(3, dtype=f), r.standard_normal(3).astype(f))


def test_database_programs_replay_their_eager_functions(captured, persist):
    """"db_correct" and "db_append" on the captured branch: the host
    arrays uploaded outside the body, each call equal to apply_correction
    / db_append_host bit for bit, one key each (appends at 1 and at CAP,
    which drops the entry but raises db_n)."""
    cfg, p = persist
    progs = teng.engine_programs(cfg, OK_MIN, MAX_DEPTH)
    cap = p.db_g.shape[0]
    Ks, D = p.db_desc.shape[1:]
    runs = []
    for seed in (0, 1):
        args = _correction(seed, cap)
        runs.append((progs["db_correct"](p, *args),
                     teng.apply_correction(p, *args)))
    for n, seed in ((1, 2), (cap, 3)):
        args = (n,) + _entry(seed, Ks, D)
        runs.append((progs["db_append"](p, *args),
                     teng.db_append_host(p, *args)))
    for got, want in runs:
        assert _equal(got, want)
    assert not _equal(runs[0][0], runs[1][0])
    assert int(runs[3][0].db_n) == cap + 1
    assert _equal(runs[3][0].db_g, p.db_g)
    assert not _equal(runs[2][0].db_g, p.db_g)
    assert [len(progs[k].program.captured) for k in
            ("db_correct", "db_append")] == [1, 1]


def test_db_append_host_takes_a_device_index(persist):
    """db_append_host with n as a 0-d tensor equals the int n, the drop
    at n >= CAP included, and leaves the caller's persist as it was."""
    _, p = persist
    cap = p.db_g.shape[0]
    Ks, D = p.db_desc.shape[1:]
    before = graphs._clone_all(p)
    for n in (0, 5, cap, cap + 3):
        entry = _entry(n, Ks, D)
        want = teng.db_append_host(p, n, *entry)
        got = teng.db_append_host(p, torch.tensor(n, dtype=torch.int32),
                                  *(torch.from_numpy(np.asarray(a))
                                    for a in entry))
        assert _equal(got, want)
        assert int(got.db_n) == max(int(p.db_n), n + 1)
    assert _equal(p, before)

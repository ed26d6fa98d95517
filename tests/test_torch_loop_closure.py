"""LoopCloser in both packages on the same keyframe entries: a drifting
loop through the injected-feature scene that revisits its start, detect()
and relocalize() on the revisit, optimize() (SE(3) and Sim(3)) after
detect() and after add_device_edge(), and the ORB bit unpack."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tracker_scene import CFG, INTR, SyntheticScene, exp_so3
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.slam.loop_closure import LoopCloser as JLoopCloser
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.slam.loop_closure import LoopCloser
from visualslam_tpu_torch.utils.config import SlamConfig

PCFG = SlamConfig.from_json(CFG.to_json())
KEYFRAMES = 14

@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes, and torch's thread pool in each of them
    oversubscribes the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



class LoopScene(SyntheticScene):
    """The scene's points seen from a path that turns back: keyframes
    0..KEYFRAMES-1 move forward then return, the last one revisits
    keyframe 0's viewpoint."""

    def pose(self, k):
        half = KEYFRAMES // 2
        s = k if k < half else (KEYFRAMES - 1 - k)
        R = exp_so3(np.array([0.0, 0.01 * s, 0.0]))
        c = np.array([0.2 * s, 0.0, 0.8 * s])
        return R.astype(np.float32), (-R @ c).astype(np.float32)


def entries(seed=4):
    """Per keyframe: features (numpy), the keypoint -> landmark ids, a
    drifted odometry pose, and the ground-truth pose."""
    rng = np.random.default_rng(seed)
    scene = LoopScene(rng, n_points=700, max_depth=40.0)
    out = []
    R_d, t_d = np.eye(3, dtype=np.float32), np.zeros(3, np.float32)
    for k in range(KEYFRAMES):
        (yx, desc, valid), (R, t) = scene.features(k)
        # keypoint k of the frame is scene point idx[k]: recover it from
        # the descriptor (unit rows, exact copies)
        lm = np.full(len(valid), -1, np.int64)
        n = int(valid.sum())
        lm[:n] = np.argmax(desc[:n] @ scene.desc.T, axis=1)
        lm[:n:3] = -1             # a third of the keypoints carry no point
        # odometry drift: 1% scale per keyframe + a small yaw
        drift = exp_so3(np.array([0.0, 0.002 * k, 0.0])).astype(np.float32)
        R_d, t_d = R @ drift, (t * (1.0 + 0.01 * k)).astype(np.float32)
        resp = rng.uniform(0.1, 1.0, len(valid)).astype(np.float32)
        out.append(dict(yx=yx, desc=desc, valid=valid, resp=resp, lm=lm,
                        R=R_d.astype(np.float32), t=t_d, R_gt=R, t_gt=t))
    return scene, out


def _feats(e, port):
    if port:
        kps = Keypoints.empty(len(e["valid"]))._replace(
            yx=torch.tensor(e["yx"]), valid=torch.tensor(e["valid"]),
            response=torch.tensor(e["resp"]))
        return Features(kps, torch.tensor(e["desc"]))
    kps = JKeypoints.empty(len(e["valid"]))._replace(
        yx=jnp.asarray(e["yx"]), valid=jnp.asarray(e["valid"]),
        response=jnp.asarray(e["resp"]))
    return JFeatures(kps, jnp.asarray(e["desc"]))


def closers(sim3: bool):
    kw = dict(sub_keypoints=128, cosine_threshold=0.3, min_inliers=25,
              exclude_recent=3, use_sim3=sim3)
    return (JLoopCloser(INTR, CFG.match, CFG.pose_graph, **kw),
            LoopCloser(INTR, PCFG.match, PCFG.pose_graph, device="cpu", **kw))


def fill(lcs, scene, es):
    X = scene.X.astype(np.float32)
    for k, e in enumerate(es):
        for lc, port in zip(lcs, (False, True)):
            idx = lc.add_keyframe(k, e["R"], e["t"], _feats(e, port), e["lm"],
                                  X)
            assert idx == k


def _same_entries(jl, pl):
    assert len(jl.entries) == len(pl.entries)
    for a, b in zip(jl.entries, pl.entries):
        assert a.frame_id == b.frame_id
        np.testing.assert_array_equal(a.desc, b.desc)
        np.testing.assert_array_equal(a.has_lm, b.has_lm)
        np.testing.assert_array_equal(a.lm_world, b.lm_world)
        np.testing.assert_allclose(a.global_desc, b.global_desc, rtol=1e-6,
                                   atol=1e-7)


def _same_corrections(jl, pl):
    """optimize() outputs: corrected poses, node scales and world-side
    corrections within float32 pose-graph tolerances (CG, 20 LM steps)."""
    n = len(jl.entries)
    for k in range(n):
        np.testing.assert_allclose(pl.corrected[k][0], jl.corrected[k][0],
                                   atol=2e-3)
        np.testing.assert_allclose(pl.corrected[k][1], jl.corrected[k][1],
                                   atol=2e-2)
        Rg, tg, sg = pl.last_corrections[k]
        Rj, tj, sj = jl.last_corrections[k]
        np.testing.assert_allclose(Rg, Rj, atol=2e-3)
        np.testing.assert_allclose(tg, tj, atol=2e-2)
        assert sg == pytest.approx(sj, abs=2e-3)
    np.testing.assert_allclose(pl.corrected_scale, jl.corrected_scale,
                               atol=2e-3)
    for a, b in zip(jl.entries, pl.entries):
        np.testing.assert_allclose(b.R, a.R, atol=2e-3)
        if a.lm_world is not None:
            np.testing.assert_allclose(b.lm_world, a.lm_world, atol=5e-2)


@pytest.mark.parametrize("sim3", [False, True])
def test_detect_and_optimize_match_jax(sim3):
    scene, es = entries()
    jl, pl = closers(sim3)
    fill((jl, pl), scene, es)
    _same_entries(jl, pl)
    j = KEYFRAMES - 1
    ej, ep = jl.detect(j), pl.detect(j)
    assert ej is not None and ep is not None, "the revisit was not closed"
    assert (ep.i, ep.j) == (ej.i, ej.j) and ej.i <= 1
    # the same matches and the same PnP inliers up to float32 LM noise
    assert abs(ep.num_inliers - ej.num_inliers) <= 2
    np.testing.assert_allclose(ep.R, ej.R, atol=1e-3)
    np.testing.assert_allclose(ep.t, ej.t, atol=1e-2)
    assert ep.scale == pytest.approx(ej.scale, rel=1e-3)
    cj, cp = jl.optimize(), pl.optimize()
    np.testing.assert_allclose(cp, cj, atol=2e-2)
    _same_corrections(jl, pl)


@pytest.mark.parametrize("sim3", [False, True])
def test_device_edge_and_optimize_match_jax(sim3):
    """Light entries (the engine's host mirror) + an edge verified on the
    device, as the tracker's _engine_apply_prom hands it over."""
    _, es = entries()
    jl, pl = closers(sim3)
    for k, e in enumerate(es):
        assert jl.add_keyframe_light(k, e["R"], e["t"]) == k
        assert pl.add_keyframe_light(k, e["R"], e["t"]) == k
    j = KEYFRAMES - 1
    # candidate camera 0's pose in the current world frame
    Rb, tb = es[0]["R_gt"], es[0]["t_gt"] * 1.1
    for lc in (jl, pl):
        lc.add_device_edge(0, j, Rb, tb, 80, 1.12, rot_sigma_deg=1.5)
    np.testing.assert_allclose(pl.loop_edges[0].R, jl.loop_edges[0].R,
                               atol=1e-6)
    np.testing.assert_allclose(pl.loop_edges[0].t, jl.loop_edges[0].t,
                               atol=1e-5)
    assert pl.loop_edges[0].scale == jl.loop_edges[0].scale
    jl.optimize()
    pl.optimize()
    _same_corrections(jl, pl)


def test_relocalize_matches_jax():
    scene, es = entries()
    jl, pl = closers(False)
    fill((jl, pl), scene, es[:KEYFRAMES - 1])
    e = es[KEYFRAMES - 1]
    rj = jl.relocalize(_feats(e, False))
    rp = pl.relocalize(_feats(e, True))
    assert rj is not None and rp is not None
    assert rp[3] == rj[3] and abs(rp[2] - rj[2]) <= 2
    np.testing.assert_allclose(rp[0], rj[0], atol=1e-3)
    np.testing.assert_allclose(rp[1], rj[1], atol=1e-2)


def test_loop_closer_unpacks_orb_bits(rng):
    lc = LoopCloser(INTR, PCFG.match.replace(metric="hamming"),
                    PCFG.pose_graph, sub_keypoints=32, device="cpu")
    jl = JLoopCloser(INTR, CFG.match.replace(metric="hamming"),
                     CFG.pose_graph, sub_keypoints=32)
    cap = 64
    desc = rng.integers(0, 2**32, (cap, 8), dtype=np.uint32)
    yx = rng.uniform(0, 100, (cap, 2)).astype(np.float32)
    kps = Keypoints.empty(cap)._replace(
        yx=torch.tensor(yx), valid=torch.ones(cap, dtype=torch.bool),
        response=torch.ones(cap))
    idx = lc.add_keyframe(0, np.eye(3, dtype=np.float32),
                          np.zeros(3, np.float32),
                          Features(kps, torch.from_numpy(desc)),
                          np.full(cap, -1), np.zeros((1, 3), np.float32))
    e = lc.entries[idx]
    assert e.desc.shape == (32, 256)       # unpacked bits
    assert set(np.unique(e.desc)) <= {0.0, 1.0}
    assert lc.match_cfg.metric == "l2"
    jkps = JKeypoints.empty(cap)._replace(
        yx=jnp.asarray(yx), valid=jnp.ones(cap, bool),
        response=jnp.ones(cap, jnp.float32))
    jl.add_keyframe(0, np.eye(3, dtype=np.float32), np.zeros(3, np.float32),
                    JFeatures(jkps, jnp.asarray(desc)), np.full(cap, -1),
                    np.zeros((1, 3), np.float32))
    np.testing.assert_array_equal(e.desc, jl.entries[0].desc)

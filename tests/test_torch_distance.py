"""The streaming 2-NN's plain version against the Pallas kernel (interpret
mode on CPU), and the matcher's impl="pallas" path against the JAX
matcher, on one numpy input fed to both."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.models.matching import match_features as jax_match
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.ops.pallas.distance import pallas_l2_2nn
from visualslam_tpu.utils.config import MatchConfig as JMatchConfig
from visualslam_tpu_torch import FAST_CONFIG, detect_and_describe
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import KERNELS, PLAIN, launch_counts
from visualslam_tpu_torch.ops.cuda.distance import (
    A_TILE,
    B_TILE,
    _cover,
    l2_2nn,
    l2_2nn_ref,
    plan_splits,
)
from visualslam_tpu_torch.utils.config import MatchConfig

# float32 |a|^2 + |b|^2 - 2 a.b summed in another order than XLA's: a few
# ulps of the largest distance in the set
REL = 1e-5


def _pallas(a, b, tile):
    best, second, idx = pallas_l2_2nn(jnp.asarray(a), jnp.asarray(b), tile,
                                      tile)
    return np.asarray(best), np.asarray(second), np.asarray(idx)


def _check_against_pallas(a, b, tile, valid=None):
    best, second, idx = (x[0].numpy() for x in l2_2nn_ref(
        torch.from_numpy(a)[None], torch.from_numpy(b)[None]))
    pb, ps, pi = _pallas(a, b, tile)
    rows = np.ones(len(a), bool) if valid is None else valid
    tol = REL * (1.0 + np.abs(pb[rows]).max())
    np.testing.assert_allclose(best[rows], pb[rows], rtol=0, atol=tol)
    np.testing.assert_allclose(second[rows], ps[rows], rtol=0, atol=tol)
    # the index may differ only where best and second are a near-tie
    tie = np.abs(ps - pb) <= 2 * tol
    np.testing.assert_array_equal(idx[rows & ~tie], pi[rows & ~tie])
    return best, second, idx


@pytest.mark.parametrize("Ka,Kb,tile", [(256, 384, 128), (128, 128, 128),
                                        (384, 256, 128)])
def test_2nn_ref_matches_pallas_several_tiles(rng, Ka, Kb, tile):
    a = rng.standard_normal((Ka, 128)).astype(np.float32)
    b = rng.standard_normal((Kb, 128)).astype(np.float32)
    _check_against_pallas(a, b, tile)


def test_2nn_ref_matches_pallas_with_masked_rows(rng):
    """Invalid rows carry the matcher's constant 1e3 descriptor; compare on
    the valid A rows (a masked row's distances are ~1.3e8, where one f32
    ulp is 8)."""
    d = rng.standard_normal((256, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    va = rng.random(256) > 0.1
    vb = rng.random(256) > 0.1
    a = np.where(va[:, None], d, 1e3).astype(np.float32)
    b = np.where(vb[:, None], d[rng.permutation(256)], 1e3).astype(np.float32)
    best, _, idx = _check_against_pallas(a, b, 128, valid=va)
    assert (best[va] < 1e6).all() and vb[idx[va]].all()


def test_2nn_ties_go_to_the_lower_index(rng):
    """Exact duplicates: descriptors on a 1/4 grid make every distance
    exact in float32, so duplicated B rows tie exactly. Both versions
    report the lower index, and a second best equal to the best."""
    b = rng.integers(0, 4, (256, 128)).astype(np.float32) / 4.0
    b[200:] = b[:56]                                   # rows 0..55 repeated
    a = b[rng.integers(0, 256, 128)]
    best, second, idx = _check_against_pallas(a, b, 128)
    first = np.array([np.nonzero((b == r).all(1))[0][0] for r in a])
    np.testing.assert_array_equal(idx, first)
    np.testing.assert_array_equal(_pallas(a, b, 128)[2], first)
    dup = (b[None] == a[:, None]).all(-1).sum(1) > 1
    assert dup.any()
    np.testing.assert_array_equal(second[dup], best[dup])
    np.testing.assert_array_equal(best, 0.0)


def test_2nn_wrapper_runs_the_plain_version_on_cpu(rng):
    a = torch.from_numpy(rng.standard_normal((2, 64, 128)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((2, 96, 128)).astype(np.float32))
    before = launch_counts()["l2_2nn"]
    for got, want in zip(l2_2nn(a, b), l2_2nn_ref(a, b)):
        assert torch.equal(got, want)
    assert launch_counts()["l2_2nn"] == before       # no kernel launched
    assert KERNELS.l2_2nn is l2_2nn and PLAIN.l2_2nn is l2_2nn_ref


def _features(desc, valid):
    K = len(valid)
    kps = JKeypoints(yx=np.zeros((K, 2), np.float32),
                     yx_oct=np.zeros((K, 2), np.float32),
                     octave=np.zeros(K, np.int32), level=np.zeros(K, np.int32),
                     sigma=np.zeros(K, np.float32),
                     orientation=np.zeros(K, np.float32),
                     response=np.zeros(K, np.float32), valid=valid)
    return JFeatures(kps, desc.astype(np.float32))


def _pair(rng, K=256, keep=0.9, noise=0.05):
    d = rng.standard_normal((K, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    perm = rng.permutation(K)
    db = d[perm] + noise * rng.standard_normal((K, 128)).astype(np.float32)
    db /= np.linalg.norm(db, axis=1, keepdims=True)
    return (_features(d, rng.random(K) < keep),
            _features(db, rng.random(K) < keep))


def _to_torch(f):
    return Features(Keypoints(*(torch.tensor(np.asarray(a))
                                for a in f.keypoints)),
                    torch.tensor(np.asarray(f.descriptors)))


def _stack(fs):
    return jax.tree_util.tree_map(lambda *a: np.stack(a), *fs)


@pytest.mark.parametrize("mutual", [True, False])
def test_match_pallas_path_equals_jax_one_pair(rng, mutual):
    fa, fb = _pair(rng)
    jcfg = JMatchConfig(max_matches=128, impl="pallas", tile=128,
                        mutual=mutual)
    want = jax_match(fa, fb, jcfg)
    got = match_features(_to_torch(fa), _to_torch(fb),
                         MatchConfig(**vars(jcfg)))
    assert int(want.count()) > 50
    for field in ("idx_a", "idx_b", "valid"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)))
    np.testing.assert_allclose(got.distance.numpy(), np.asarray(want.distance),
                               atol=1e-5)


def test_match_pallas_path_equals_jax_batched_pairs(rng):
    pairs = [_pair(rng) for _ in range(3)]
    jcfg = JMatchConfig(max_matches=128, impl="pallas", tile=128)
    got = match_features(_to_torch(_stack([p[0] for p in pairs])),
                         _to_torch(_stack([p[1] for p in pairs])),
                         MatchConfig(**vars(jcfg)))
    assert got.idx_a.shape == (3, 128)
    for i, (fa, fb) in enumerate(pairs):
        want = jax_match(fa, fb, jcfg)
        for field in ("idx_a", "idx_b", "valid"):
            np.testing.assert_array_equal(getattr(got, field)[i].numpy(),
                                          np.asarray(getattr(want, field)))


def test_match_pallas_path_equals_dense_path(rng):
    """The reference's two paths agree on well-separated matches; so do the
    port's (PLAIN and KERNELS are the same on CPU tensors)."""
    fa, fb = _pair(rng)
    ta, tb = _to_torch(fa), _to_torch(fb)
    cfg = MatchConfig(max_matches=256, tile=128)
    dense = match_features(ta, tb, cfg)
    for kernels in (KERNELS, PLAIN):
        twonn = match_features(ta, tb, cfg.replace(impl="pallas"), kernels)
        for field in ("idx_a", "idx_b", "valid"):
            assert torch.equal(getattr(twonn, field), getattr(dense, field))


def test_match_falls_to_dense_path_off_tile():
    """The JAX dispatch condition: capacities not divisible by the tile run
    the dense path (no 2-NN call), as in the reference."""
    calls = []

    def spy(a, b):
        calls.append(a.shape)
        return l2_2nn_ref(a, b)

    r = np.random.default_rng(1)
    fa, fb = _pair(r, K=192)
    cfg = MatchConfig(max_matches=64, impl="pallas", tile=128)
    match_features(_to_torch(fa), _to_torch(fb), cfg,
                   PLAIN._replace(l2_2nn=spy))
    assert calls == []
    match_features(_to_torch(fa), _to_torch(fb), cfg.replace(tile=64),
                   PLAIN._replace(l2_2nn=spy))
    assert len(calls) == 2                           # forward + mutual


@pytest.mark.parametrize("P,Ka,Kb,sms", [
    (1, 2048, 2048, 132),             # a tracked frame: the B range split
    (15, 2048, 2048, 132),            # the frontend's pairs: no split
    (1, 100, 37, 132),                # one B tile
    (2, 257, 200, 132),               # ragged A and B
    (1, 64, 2048, 7),                 # few SMs
    (1, 2048, 1000, 1000),            # more SMs than tiles
])
def test_split_planner_covers_every_tile_once(P, Ka, Kb, sms):
    n_tiles = -(-Kb // B_TILE)
    blocks = P * -(-Ka // A_TILE)
    # blocks per SM: 2 is the D = 128 build's occupancy on the H100
    for per_sm in (1, 2, 5):
        nsplit, per = plan_splits(P, Ka, Kb, sms, per_sm)
        tiles = [t for s in range(nsplit)
                 for t in range(s * per, min((s + 1) * per, n_tiles))]
        assert sorted(tiles) == list(range(n_tiles))      # each exactly once
        assert all(s * per < n_tiles for s in range(nsplit))  # none empty
        assert nsplit == 1 or blocks * nsplit <= per_sm * sms
    # an explicit split count (the GPU tests' 1, 2, 7, the tile count) is
    # covered the same way
    for want in (1, 2, 7, n_tiles, n_tiles + 3):
        ns, pr = _cover(n_tiles, want)
        assert ns <= min(want, n_tiles) and (ns - 1) * pr < n_tiles <= ns * pr


def _tf32(x):
    """float32 -> tf32 as the kernel rounds: to nearest, ties away from
    zero, the 13 low mantissa bits cleared."""
    u = np.ascontiguousarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xffffe000)).view(np.float32)


def _2nn_3xtf32(a, b):
    """The kernel's arithmetic on the CPU: a.b as lo.hi + hi.lo + hi.hi of
    the tf32 parts, summed in float32; norms in float32."""
    ah, bh = _tf32(a), _tf32(b)
    al, bl = _tf32(a - ah), _tf32(b - bh)
    dot = (al @ bh.T) + (ah @ bl.T) + (ah @ bh.T)
    d = np.maximum((a * a).sum(1)[:, None] + (b * b).sum(1)[None]
                   - np.float32(2) * dot, np.float32(0))
    idx = d.argmin(1)
    best = d[np.arange(len(a)), idx]
    rest = d.copy()
    rest[np.arange(len(a)), idx] = np.inf
    return best, rest.min(1), idx


@pytest.fixture(scope="module")
def frame_descriptors():
    """The port frontend's descriptors of two synthetic frames at a small
    size, as the matcher hands them to the 2-NN: invalid rows and a
    seeded ~10% of the valid ones set to 1e3."""
    seq = SyntheticSequence(num_frames=2, h=96, w=256, n_dots=600)
    frames = np.stack([seq.frame(k) for k in range(2)])
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    cfg = FAST_CONFIG.replace(
        pyramid=FAST_CONFIG.pyramid.replace(num_octaves=2),
        sift=FAST_CONFIG.sift.replace(max_keypoints=256,
                                      max_keypoints_per_octave=128))
    f = detect_and_describe(torch.from_numpy(frames), cfg)
    keep = np.random.default_rng(0).random((2, 256)) > 0.1
    valid = f.keypoints.valid.numpy() & keep
    d = np.where(valid[..., None], f.descriptors.numpy(), 1e3)
    return d.astype(np.float32), valid


def test_3xtf32_products_match_pallas_on_frame_descriptors(
        frame_descriptors):
    """The tensor-core route's products (emulated) against the Pallas
    kernel (interpret mode) on real descriptors: the same indices off
    near-ties, best and second within 1e-5 x (1 + max)."""
    d, valid = frame_descriptors
    a, b, va = d[0], d[1], valid[0]
    assert va.sum() > 100
    best, second, idx = _2nn_3xtf32(a, b)
    pb, ps, pi = _pallas(a, b, 128)
    tol = REL * (1.0 + np.abs(np.concatenate([pb[va], ps[va]])).max())
    np.testing.assert_allclose(best[va], pb[va], rtol=0, atol=tol)
    np.testing.assert_allclose(second[va], ps[va], rtol=0, atol=tol)
    near = np.abs(ps - pb) <= tol
    np.testing.assert_array_equal(idx[va & ~near], pi[va & ~near])


def test_3xtf32_products_are_exact_on_the_quarter_grid(rng):
    """Descriptors on a 1/4 grid split with lo = 0 and every product exact:
    the emulated kernel arithmetic gives the plain version's bits, ties to
    the lower index included."""
    b = rng.integers(0, 4, (256, 128)).astype(np.float32) / 4.0
    b[200:] = b[:56]
    a = b[rng.integers(0, 256, 128)]
    got = _2nn_3xtf32(a, b)
    want = [x[0].numpy() for x in l2_2nn_ref(torch.from_numpy(a)[None],
                                             torch.from_numpy(b)[None])]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("metric", ["l2", "hamming"])
def test_distance_matrix_equals_jax(rng, metric):
    """models/matching.distance_matrix against the JAX package's on the
    same descriptors: squared L2 on float descriptors (within a few ulps
    of the largest distance: another summation order), Hamming on packed
    uint32 words (equal)."""
    from visualslam_tpu.models.matching import distance_matrix as jax_dm
    from visualslam_tpu_torch.models.matching import distance_matrix

    if metric == "l2":
        da = rng.standard_normal((200, 128)).astype(np.float32)
        db = rng.standard_normal((300, 128)).astype(np.float32)
    else:
        da = rng.integers(0, 2 ** 32, (200, 8), dtype=np.uint64).astype(
            np.uint32)
        db = rng.integers(0, 2 ** 32, (300, 8), dtype=np.uint64).astype(
            np.uint32)

    def feats(d, K, F, kps):
        return F(kps.empty(K), d)

    got = distance_matrix(
        feats(torch.from_numpy(da), 200, Features, Keypoints),
        feats(torch.from_numpy(db), 300, Features, Keypoints),
        metric).numpy()
    want = np.asarray(jax_dm(
        feats(jnp.asarray(da), 200, JFeatures, JKeypoints),
        feats(jnp.asarray(db), 300, JFeatures, JKeypoints), metric))
    if metric == "l2":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=REL * (1.0 + np.abs(want).max()))
    else:
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="unknown metric"):
        distance_matrix(feats(torch.from_numpy(da), 200, Features,
                              Keypoints),
                        feats(torch.from_numpy(da), 200, Features,
                              Keypoints), "cosine")

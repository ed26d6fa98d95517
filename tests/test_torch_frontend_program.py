"""The frontend programs on the CPU: `frontend.detect_and_describe_jit`,
`models.build_pyramid_jit`, `detect_and_describe_sift_jit`,
`detect_and_describe_orb_jit`, `detect_harris_jit`, the tracker's
"frontend" / "frontend_batched" and `slam.two_view.
two_view_reconstruction_jit`.

On the card each replays a captured CUDA graph per shape key
(utils/graphs.GraphProgram); on the CPU each is its eager function. Here:
each program equals its eager port function bit for bit on the CPU, and so
does its data flow run uncaptured over its static buffers
(`ProgramGraph(graphs=False)`), for two inputs of one key, the first
result kept across the second run; each name against the JAX package's
namesake on the same input (batched through jax.vmap) at the tolerances
of tests/test_torch_{frontend,orb,harris,pyramid}.py;
two_view_reconstruction_jit against the JAX package's two-view
reconstruction with its RANSAC draws replayed; no second call of a
frontend makes a tensor from host memory (the CPU's view of "it
captures"); and the tracker's detection through its shared program, on the
captured branch's data flow too (a stand-in capture)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu import frontend as jfe
from visualslam_tpu.geometry import ransac as jrs
from visualslam_tpu.models import harris as jharris
from visualslam_tpu.models import orb as jorb
from visualslam_tpu.models import pyramid as jpyr
from visualslam_tpu.models import sift as jsift
from visualslam_tpu.slam import two_view as jtv
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch import frontend as tfe
from visualslam_tpu_torch.geometry import ransac as trs
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models import harris as tharris
from visualslam_tpu_torch.models import orb as torb
from visualslam_tpu_torch.models import pyramid as tpyr
from visualslam_tpu_torch.models import sift as tsift
from visualslam_tpu_torch.ops.cuda import KERNELS
from visualslam_tpu_torch.slam import tracker as ttr
from visualslam_tpu_torch.slam import two_view as ttv
from visualslam_tpu_torch.utils import graphs
from visualslam_tpu_torch.utils.config import (
    DEFAULT_CONFIG,
    FAST_CONFIG,
    SlamConfig,
)

# FAST at 2 octaves with capacities 128 per octave / 256 in all and the
# JAX package's accelerator defaults pinned (tests/test_torch_frontend.py)
SIFT_FAST = FAST_CONFIG.replace(
    pyramid=FAST_CONFIG.pyramid.replace(num_octaves=2),
    sift=FAST_CONFIG.sift.replace(max_keypoints=256,
                                  max_keypoints_per_octave=128,
                                  extrema_impl="fused", patch_impl="pallas",
                                  hist_compute="bf16"))
# the reference profile (2x upsample, float32 patches) at 2 octaves
SIFT_REF = DEFAULT_CONFIG.replace(
    pyramid=DEFAULT_CONFIG.pyramid.replace(num_octaves=2),
    sift=DEFAULT_CONFIG.sift.replace(max_keypoints=256,
                                     max_keypoints_per_octave=128))
# tests/test_torch_orb.py's and tests/test_torch_harris.py's frontends
ORB = SlamConfig().replace(
    frontend="orb", orb=SlamConfig().orb.replace(num_levels=4,
                                                 max_keypoints=512))
HARRIS = DEFAULT_CONFIG.replace(
    frontend="harris",
    harris=DEFAULT_CONFIG.harris.replace(max_keypoints=256))
# config, frame size of the inputs
FRONTENDS = {"sift_fast": (SIFT_FAST, (96, 256)),
             "sift_reference": (SIFT_REF, (64, 96)),
             "orb": (ORB, (120, 160)),
             "harris": (HARRIS, (120, 160))}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread (the suite runs files in parallel workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jax(cfg: SlamConfig):
    return jcfg.SlamConfig.from_json(cfg.to_json())


def _frames(hw, n=3, dots=600) -> np.ndarray:
    """n uint8 frames of the synthetic sequence."""
    seq = SyntheticSequence(num_frames=n, h=hw[0], w=hw[1], n_dots=dots)
    f = np.stack([seq.frame(k) for k in range(n)])
    return np.clip(f * 255.0, 0, 255).astype(np.uint8)


def _float(u8: np.ndarray) -> np.ndarray:
    """The frontend's uint8 normalization, in float32."""
    return u8.astype(np.float32) * np.float32(1.0 / 255.0)


def _equal(a, b) -> bool:
    la, lb = graphs._leaves(a), graphs._leaves(b)
    return len(la) == len(lb) and all(
        x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))


def _cases() -> dict:
    """name -> (program, cfg, x of frames 0..1 and 1..2, eager function of
    x): every program of the frontend and its eager port function."""
    out = {}
    for name, (cfg, hw) in FRONTENDS.items():
        u8 = torch.from_numpy(_frames(hw))
        xs = [(u8[k:k + 2],) for k in (0, 1)]
        fl = [(torch.from_numpy(_float(x[0].numpy())),) for x in xs]
        out[f"detect_{name}"] = (
            tfe.detect_and_describe_jit.program, (cfg, KERNELS), xs,
            lambda x, c=cfg: tfe.detect_and_describe(x[0], c))
        if name.startswith("sift"):
            out[f"pyramid_{name[5:]}"] = (
                tpyr.build_pyramid_jit.program, (cfg.pyramid, KERNELS), fl,
                lambda x, c=cfg: tpyr.build_pyramid(x[0], c.pyramid))
            out[name] = (
                tsift.detect_and_describe_sift_jit.program,
                ((cfg.pyramid, cfg.sift), KERNELS), fl,
                lambda x, c=cfg: tsift.detect_and_describe_sift(
                    x[0], c.pyramid, c.sift))
        elif name == "orb":
            out[name] = (torb.detect_and_describe_orb_jit.program,
                         (cfg.orb, KERNELS), fl,
                         lambda x, c=cfg: torb.detect_and_describe_orb(
                             x[0], c.orb))
        else:
            out[name] = (tharris.detect_harris_jit.program,
                         (cfg.harris, KERNELS), fl,
                         lambda x, c=cfg: tharris.detect_harris(x[0],
                                                                c.harris))
    return out


CASES = _cases()
PUBLIC = {tfe.detect_and_describe_jit.program:
          lambda x, c: tfe.detect_and_describe_jit(x[0], *c),
          tpyr.build_pyramid_jit.program:
          lambda x, c: tpyr.build_pyramid_jit(x[0], *c),
          tsift.detect_and_describe_sift_jit.program:
          lambda x, c: tsift.detect_and_describe_sift_jit(x[0], *c[0], c[1]),
          torb.detect_and_describe_orb_jit.program:
          lambda x, c: torb.detect_and_describe_orb_jit(x[0], c[0]),
          tharris.detect_harris_jit.program:
          lambda x, c: tharris.detect_harris_jit(x[0], c[0])}


@pytest.mark.parametrize("case", sorted(CASES))
def test_program_and_its_uncaptured_data_flow_equal_the_eager_function(case):
    """The public name on the CPU is the eager function (nothing captured),
    and the program's data flow over its static buffers, uncaptured, gives
    the eager function's bits for two inputs of one key, handing back
    copies: the second run leaves the first result as it was. ORB's
    descriptors stay uint32."""
    prog, cfg, xs, eager = CASES[case]
    want = [eager(x) for x in xs]
    assert _equal(PUBLIC[prog](xs[0], cfg), want[0])
    assert not prog.captured
    uncaptured = graphs.ProgramGraph(prog, xs[0], cfg, graphs=False)
    got = [uncaptured.run(x) for x in xs]
    for g, w in zip(got, want):
        assert _equal(g, w)
    assert not _equal(got[0], got[1])
    assert _equal(got[0], eager(xs[0]))
    if case.endswith("orb"):
        assert got[0].descriptors.dtype == torch.uint32


@pytest.mark.parametrize("name", sorted(FRONTENDS))
def test_second_call_makes_no_tensor_from_host_memory(monkeypatch, name):
    """After one call has built the constants, a frontend call (other
    frames, the same shapes) calls none of torch.from_numpy, torch.tensor
    and torch.as_tensor: no copy from host memory, which a CUDA graph
    capture refuses."""
    cfg, hw = FRONTENDS[name]
    u8 = torch.from_numpy(_frames(hw))
    tfe.detect_and_describe_jit(u8[:2], cfg)
    calls = []
    for fn in ("from_numpy", "tensor", "as_tensor"):
        real = getattr(torch, fn)

        def counted(*a, _real=real, _fn=fn, **kw):
            calls.append(_fn)
            return _real(*a, **kw)

        monkeypatch.setattr(torch, fn, counted)
    out = tfe.detect_and_describe_jit(u8[1:], cfg)
    assert calls == []
    assert int(out.keypoints.valid.sum()) > 50


# --- against the JAX package's `*_jit` names ---------------------------


def _jax_batched(fn, *xs):
    with jax.default_matmul_precision("float32"):
        out = jax.vmap(fn)(*(jnp.asarray(x) for x in xs))
    return jax.tree_util.tree_map(np.asarray, out)


def _sift_close(want, got, n):
    """tests/test_torch_frontend.py's criteria: counts within 5%, >= 95%
    of the JAX package's keypoints within 0.5 px of the port's, median
    descriptor cosine of coincident keypoints > 0.999."""
    for b in range(n):
        vx = want.keypoints.valid[b]
        vp = got.keypoints.valid[b].numpy()
        nx = int(vx.sum())
        assert nx > 30
        assert abs(int(vp.sum()) - nx) <= max(2, 0.05 * nx)
        a = want.keypoints.yx[b][vx]
        p = got.keypoints.yx[b].numpy()[vp]
        d = np.linalg.norm(a[:, None] - p[None, :], axis=-1)
        assert (d.min(axis=1) < 0.5).mean() > 0.95
        j = d.argmin(axis=1)
        close = d.min(axis=1) < 1e-3
        dx = want.descriptors[b][vx][close]
        dp = got.descriptors[b].numpy()[vp][j[close]]
        cos = (dx * dp).sum(1) / np.maximum(
            np.linalg.norm(dx, axis=1) * np.linalg.norm(dp, axis=1), 1e-9)
        assert np.median(cos) > 0.999


def _bits(d: np.ndarray) -> np.ndarray:
    return np.unpackbits(np.ascontiguousarray(d).view(np.uint8), axis=-1)


def _orb_close(want, got, n):
    """tests/test_torch_orb.py's criteria: keypoints as a set matched by
    (position, level), counts within 5%, >= 95% within 0.5 px at the same
    level; Hamming distance of coincident keypoints' descriptors median 0
    and at most 8 of 256 bits on >= 98% of them."""
    assert got.descriptors.dtype == torch.uint32
    for b in range(n):
        vx = want.keypoints.valid[b]
        vp = got.keypoints.valid[b].numpy()
        assert vx.sum() > 200
        assert abs(int(vp.sum()) - int(vx.sum())) <= 0.05 * vx.sum()

        def key(yx, lvl):
            return np.concatenate(
                [yx, 1e4 * lvl[:, None].astype(np.float32)], 1)

        a = key(want.keypoints.yx[b][vx], want.keypoints.level[b][vx])
        p = key(got.keypoints.yx[b].numpy()[vp],
                got.keypoints.level[b].numpy()[vp])
        d = np.linalg.norm(a[:, None] - p[None], axis=-1)
        assert (d.min(axis=1) < 0.5).mean() >= 0.95
        close = d.min(axis=1) < 1e-3
        j = d.argmin(axis=1)[close]
        ham = (_bits(want.descriptors[b][vx][close])
               != _bits(got.descriptors[b].numpy()[vp][j])).sum(1)
        assert np.median(ham) == 0 and (ham <= 8).mean() >= 0.98


def _harris_close(want, got):
    """tests/test_torch_harris.py's criteria: the same valid slots, equal
    positions where no response ties (>= 99%), and the descriptors there
    within 1e-6."""
    np.testing.assert_array_equal(got.keypoints.valid.numpy(),
                                  want.keypoints.valid)
    same = (got.keypoints.yx.numpy() == want.keypoints.yx).all(-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got.descriptors.numpy()[same],
                               want.descriptors[same], rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", ["sift_fast", "orb", "harris"])
def test_detect_and_describe_jit_matches_jax(name):
    """detect_and_describe_jit on uint8 frames against the JAX package's
    detect_and_describe_jit vmapped over the same frames."""
    cfg, hw = FRONTENDS[name]
    u8 = _frames(hw, n=2)
    jc = _jax(cfg)
    want = _jax_batched(lambda i: jfe.detect_and_describe_jit(i, jc), u8)
    got = tfe.detect_and_describe_jit(torch.from_numpy(u8), cfg)
    if name == "orb":
        _orb_close(want, got, 2)
    elif name == "harris":
        _harris_close(want, got)
    else:
        _sift_close(want, got, 2)


def test_detect_and_describe_sift_jit_matches_jax():
    cfg, hw = FRONTENDS["sift_fast"]
    img = _float(_frames(hw, n=2))
    jc = _jax(cfg)
    want = _jax_batched(lambda i: jsift.detect_and_describe_sift_jit(
        i, jc.pyramid, jc.sift), img)
    got = tsift.detect_and_describe_sift_jit(torch.from_numpy(img),
                                             cfg.pyramid, cfg.sift)
    _sift_close(want, got, 2)


def test_detect_and_describe_orb_jit_matches_jax():
    cfg, hw = FRONTENDS["orb"]
    img = _float(_frames(hw, n=2, dots=500))
    jc = _jax(cfg)
    want = _jax_batched(lambda i: jorb.detect_and_describe_orb_jit(
        i, jc.orb), img)
    _orb_close(want, torb.detect_and_describe_orb_jit(
        torch.from_numpy(img), cfg.orb), 2)


def test_detect_harris_jit_matches_jax(rng):
    """Random-grey checkerboards (tests/test_torch_harris.py): the same
    valid slots, corners (response > 1e-8) at equal positions with
    responses within 1e-6, and the constant fields equal."""
    n, sq = 96, 12
    y, x = np.mgrid[0:n, 0:n]
    imgs = np.stack([rng.uniform(0.0, 1.0, (n // s + 1, n // s + 1))[
        y // s, x // s] for s in (sq, 16)]).astype(np.float32)
    cfg = HARRIS.harris
    want = _jax_batched(lambda i: jharris.detect_harris_jit(
        i, _jax(HARRIS).harris), imgs)
    got = tharris.detect_harris_jit(torch.from_numpy(imgs), cfg)
    np.testing.assert_array_equal(got.valid.numpy(), want.valid)
    corner = want.response > 1e-8
    assert corner.sum() > 60
    np.testing.assert_array_equal(got.response.numpy() > 1e-8, corner)
    np.testing.assert_array_equal(got.yx.numpy()[corner], want.yx[corner])
    np.testing.assert_allclose(got.response.numpy()[corner],
                               want.response[corner], rtol=0, atol=1e-6)
    for f in ("octave", "level", "sigma", "orientation"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      getattr(want, f))


@pytest.mark.parametrize("name", ["sift_fast", "sift_reference"])
def test_build_pyramid_jit_matches_jax(name):
    """tests/test_torch_pyramid.py's tolerance: every Gaussian, DoG and
    magnitude stack within 1e-5 (float32 products summed in another
    order)."""
    cfg, hw = FRONTENDS[name]
    img = _float(_frames(hw, n=2))
    want = _jax_batched(lambda i: jpyr.build_pyramid_jit(
        i, _jax(cfg).pyramid), img)
    got = tpyr.build_pyramid_jit(torch.from_numpy(img), cfg.pyramid)
    for field in ("gauss", "dog", "grad_mag"):
        for o, (g, w) in enumerate(zip(getattr(got, field),
                                       getattr(want, field))):
            assert g.shape == w.shape
            np.testing.assert_allclose(g.numpy(), w, rtol=0, atol=1e-5,
                                       err_msg=f"{field} octave {o}")


# --- two-view reconstruction from pixels --------------------------------


def _replay(key, valid, N, n):
    """The JAX package's sample indices for key (tests/test_torch_two_view
    .replay)."""
    keys = jax.random.split(key, N)
    return np.asarray(jax.vmap(
        lambda k: jrs._gumbel_sample_indices(k, jnp.asarray(valid), n))(keys))


TWO_VIEW = SIFT_FAST.replace(
    sift=SIFT_FAST.sift.replace(max_keypoints=512,
                                max_keypoints_per_octave=256),
    ransac=SIFT_FAST.ransac.replace(num_hypotheses=128))


def _two_view_inputs():
    """Frames 0 and 6 of a 120x320 sequence (65 matches), the intrinsics."""
    seq = SyntheticSequence(num_frames=7, h=120, w=320, n_dots=1000)
    u8 = np.clip(np.stack([seq.frame(0), seq.frame(6)]) * 255.0, 0,
                 255).astype(np.uint8)
    return u8, np.asarray(seq.intrinsics, np.float32)


def test_two_view_reconstruction_jit_equals_its_eager_function():
    """On the CPU the program is two_view_reconstruction with
    generator(seed); its data flow run uncaptured (the frontend on both
    frames, the match, RANSAC, pose and points over one key's static
    buffers) equals it bit for bit, for two seeds."""
    u8, intr = _two_view_inputs()
    x = (torch.from_numpy(u8[0]), torch.from_numpy(u8[1]),
         torch.from_numpy(intr))
    cfg = (TWO_VIEW, KERNELS)
    prog = ttv.two_view_reconstruction_jit.program
    uncaptured = graphs.ProgramGraph(prog, x, cfg, graphs=False)
    for seed in (5, 6):
        want = ttv.two_view_reconstruction(*x, TWO_VIEW,
                                           trs.generator(seed, "cpu"))
        assert _equal(ttv.two_view_reconstruction_jit(*x, TWO_VIEW, seed),
                      want)
        assert _equal(uncaptured.run(x, seed), want)
    assert not prog.captured


@pytest.fixture()
def replayed(monkeypatch):
    """Point the port's sampler at a queue of replayed draws."""
    queue = []

    def sample(gen, valid, N, n):
        return torch.as_tensor(queue.pop(0), device=valid.device)

    monkeypatch.setattr(trs, "sample_indices", sample)
    return queue


def test_two_view_reconstruction_jit_matches_jax(replayed):
    """Pixels to pose in both packages on frames 0 and 6, the JAX
    package's RANSAC draws replayed into the port. The two frontends'
    keypoints differ by their float32 sums (tests/test_torch_frontend.py's
    criteria), so the match lists differ in a few slots and a replayed
    sample may hold other correspondences: the valid matches within 5%,
    the final inliers within 10%, the rotations within 0.1 deg of each
    other and the unit translations within 5e-3, as
    tests/test_torch_two_view.py holds two-view init on shared features."""
    u8, intr = _two_view_inputs()
    jc = _jax(TWO_VIEW)
    key = jax.random.PRNGKey(3)
    with jax.default_matmul_precision("float32"):
        ref = jtv.two_view_reconstruction_jit(
            jnp.asarray(u8[0]), jnp.asarray(u8[1]), jnp.asarray(intr), jc,
            key)
    replayed.append(_replay(key, np.asarray(ref.matches.valid),
                            jc.ransac.num_hypotheses, jc.ransac.sample_size))
    got = ttv.two_view_reconstruction_jit(
        torch.from_numpy(u8[0]), torch.from_numpy(u8[1]),
        torch.from_numpy(intr), TWO_VIEW, 3)
    assert not replayed
    nj = int(np.asarray(ref.matches.valid).sum())
    assert abs(int(got.matches.valid.sum()) - nj) <= 0.05 * nj
    ij = int(ref.num_inliers)
    assert ij > 40
    assert abs(int(got.num_inliers) - ij) <= 0.1 * ij
    dR = got.R.numpy() @ np.asarray(ref.R).T
    assert np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))) < 0.1
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-3)


# --- the tracker's programs ---------------------------------------------


def test_tracker_detects_through_its_shared_frontend_program():
    """"frontend" and "frontend_batched" are one program shared per config
    (the port's frontend is batched: the single-frame program is its B = 1
    key); detect_batch and process's detection equal the tracker's eager
    module bit for bit, and on the CPU nothing is captured."""
    progs = ttr._shared_programs(SIFT_FAST)
    assert progs["frontend"] is progs["frontend_batched"]
    u8 = _frames(FRONTENDS["sift_fast"][1])
    tr = ttr.Tracker(SIFT_FAST, np.array([200.0, 200.0, 128.0, 48.0]),
                     device="cpu", loop_closure=False)
    assert tr._progs is progs
    assert _equal(tr.detect_batch(u8[:2]),
                  tr.frontend(torch.from_numpy(u8[:2])))
    assert _equal(tr.detect_batch(u8[2:]), tr.frontend(torch.from_numpy(
        u8[2:])))
    assert not progs["frontend"].captured


class _StandInCapture:
    """utils.graphs._Capture on the CPU: the warm-up runs, and each body
    is kept to be run as it is on every replay."""

    def __init__(self, dev):
        self.scratch = {}

    def warm_up(self, fn):
        fn()

    def graph(self, body, generators=()):
        return graphs._Uncaptured(body)

    def done(self):
        return 0.0, 0


def test_tracker_frontend_keys_on_the_captured_branch(monkeypatch):
    """The captured branch's data flow on the CPU (a stand-in capture, the
    program made to replay): one key per batch shape, a result held
    across a later call with other frames keeps its values (the lag-1
    stream's case), each equals the eager module, and prewarm_aux prepares
    the stream's batch shape."""
    monkeypatch.setattr(graphs, "_Capture", _StandInCapture)
    monkeypatch.setattr(graphs.GraphProgram, "_replays",
                        lambda self, x, cfg: True)
    # a config of this test alone: its shared programs start empty
    cfg = SIFT_FAST.replace(keyframe_min_inliers=1 + SIFT_FAST
                            .keyframe_min_inliers)
    tr = ttr.Tracker(cfg, np.array([200.0, 200.0, 128.0, 48.0]),
                     device="cpu", loop_closure=False)
    prog = tr._progs["frontend_batched"]
    u8 = _frames(FRONTENDS["sift_fast"][1])
    first = tr.detect_batch(u8[:2])
    kept = graphs._clone_all(first)
    second = tr.detect_batch(u8[1:])
    assert len(prog.captured) == 1
    assert _equal(first, kept)
    assert not _equal(first, second)
    assert _equal(second, tr.frontend(torch.from_numpy(u8[1:])))
    one = tr.detect_batch(u8[2:])
    assert _equal(one, tr.frontend(torch.from_numpy(u8[2:])))
    assert len(prog.captured) == 2
    tr._stream_B = 3                 # as process_stream sets it
    tr.prewarm_aux()
    assert [k[0][0][0] for k in prog.captured] == [(2, 96, 256),
                                                   (1, 96, 256),
                                                   (3, 96, 256)]


# --- ops/patches: rotations from Python values --------------------------


def test_rotations_from_python_values_match_jax(rng, monkeypatch):
    """rotate_points, rotate_image and extract_rotated_patches (a step
    other than 1, as a number and as a tensor) take Python angles, centres
    and steps by device fills, never from host memory, and match the JAX
    package's functions within float32 rounding of the sampled values."""
    from visualslam_tpu.ops import patches as jpat
    from visualslam_tpu_torch.ops import patches as tpat

    img = rng.random((2, 40, 52), dtype=np.float32)
    yx = np.stack([rng.uniform(8, 30, 6), rng.uniform(8, 42, 6)],
                  -1).astype(np.float32)
    ang = rng.uniform(0, 360, 6).astype(np.float32)
    timg, tyx = torch.from_numpy(img), torch.from_numpy(yx)
    tang = torch.from_numpy(ang)
    calls = []
    for fn in ("from_numpy", "tensor", "as_tensor"):
        real = getattr(torch, fn)
        monkeypatch.setattr(torch, fn, lambda *a, _r=real, _f=fn, **kw: (
            calls.append(_f), _r(*a, **kw))[1])
    pts = tpat.rotate_points(tyx, 33.0, (20.0, 26.0))
    back = tpat.rotate_points(pts, 33.0, (20.0, 26.0), clockwise=True)
    rot = tpat.rotate_image(timg, 90.0)
    win = tpat.extract_rotated_patches(timg, tyx[None].expand(2, 6, 2),
                                       tang[None].expand(2, 6), 8, 1.5)
    win_t = tpat.extract_rotated_patches(
        timg, tyx[None].expand(2, 6, 2), tang[None].expand(2, 6), 8,
        torch.full((2, 6), 1.5))
    assert calls == []
    monkeypatch.undo()
    np.testing.assert_allclose(pts.numpy(), np.asarray(jpat.rotate_points(
        jnp.asarray(yx), 33.0, (20.0, 26.0))), rtol=0, atol=1e-5)
    np.testing.assert_allclose(back.numpy(), yx, rtol=0, atol=1e-4)
    for b in range(2):
        np.testing.assert_allclose(rot[b].numpy(), np.asarray(
            jpat.rotate_image(jnp.asarray(img[b]), 90.0)), rtol=0,
            atol=1e-5)
        want = np.asarray(jpat.extract_rotated_patches(
            jnp.asarray(img[b]), jnp.asarray(yx), jnp.asarray(ang), 8, 1.5))
        np.testing.assert_allclose(win[b].numpy(), want, rtol=0, atol=1e-5)
    assert torch.equal(win, win_t)

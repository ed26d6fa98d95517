"""The port's frontend slice end to end against the JAX package: frames from
the synthetic sequence through detection, description and frame-to-frame
matching, the numpy sequence copy, and the port's import isolation."""

import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.frontend import detect_and_describe as jax_detect
from visualslam_tpu.io.kitti import SyntheticSequence as JaxSequence
from visualslam_tpu.models.matching import match_features as jax_match
from visualslam_tpu.models.types import Features as JFeatures
from visualslam_tpu.models.types import Keypoints as JKeypoints
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch import FAST_CONFIG, detect_and_describe, match_features
from visualslam_tpu_torch.frontend import SiftFrontend
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.utils.config import SlamConfig

N_FRAMES = 3


def _small(cfg):
    """FAST at 2 octaves with capacities 128 per octave / 256 in all, and
    the JAX package's accelerator defaults pinned (on CPU its "auto" takes
    the XLA path, which selects extrema differently and never uses bf16
    patches)."""
    return cfg.replace(
        pyramid=cfg.pyramid.replace(num_octaves=2),
        sift=cfg.sift.replace(max_keypoints=256, max_keypoints_per_octave=128,
                              extrema_impl="fused", patch_impl="pallas",
                              hist_compute="bf16"))


@pytest.fixture(scope="module")
def frames():
    seq = SyntheticSequence(num_frames=N_FRAMES, h=96, w=256, n_dots=600)
    f = np.stack([seq.frame(k) for k in range(N_FRAMES)])
    return np.clip(f * 255.0, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def jax_feats(frames):
    cfg = _small(jcfg.FAST_CONFIG)
    fn = jax.jit(jax.vmap(lambda im: jax_detect(im, cfg)))
    return jax.tree_util.tree_map(np.asarray, fn(jnp.asarray(frames)))


@pytest.fixture(scope="module")
def port_feats(frames):
    cfg = SlamConfig.from_json(_small(jcfg.FAST_CONFIG).to_json())
    return detect_and_describe(torch.from_numpy(frames), cfg)


def test_frontend_matches_jax(jax_feats, port_feats):
    """Same criteria as tests/test_pallas_descriptor.py's frontend check:
    counts within 5%, >= 95% of keypoints within 0.5 px of a counterpart,
    median descriptor cosine of coincident keypoints > 0.999."""
    assert port_feats.descriptors.shape == (N_FRAMES, 256, 128)
    for b in range(N_FRAMES):
        vx = jax_feats.keypoints.valid[b]
        vp = port_feats.keypoints.valid[b].numpy()
        nx = int(vx.sum())
        assert nx > 30
        assert abs(int(vp.sum()) - nx) <= max(2, 0.05 * nx)
        a = jax_feats.keypoints.yx[b][vx]
        p = port_feats.keypoints.yx[b].numpy()[vp]
        d = np.linalg.norm(a[:, None] - p[None, :], axis=-1)
        assert (d.min(axis=1) < 0.5).mean() > 0.95
        j = d.argmin(axis=1)
        close = d.min(axis=1) < 1e-3
        dx = jax_feats.descriptors[b][vx][close]
        dp = port_feats.descriptors[b].numpy()[vp][j[close]]
        cos = (dx * dp).sum(1) / np.maximum(
            np.linalg.norm(dx, axis=1) * np.linalg.norm(dp, axis=1), 1e-9)
        assert np.median(cos) > 0.999


def test_sift_frontend_module_equals_function(frames, port_feats):
    cfg = SlamConfig.from_json(_small(jcfg.FAST_CONFIG).to_json())
    mod = SiftFrontend(cfg)
    out = mod(torch.from_numpy(frames))
    assert any(k.startswith("bands.band_") for k, _ in mod.named_buffers())
    assert torch.equal(out.descriptors, port_feats.descriptors)
    assert torch.equal(out.keypoints.yx, port_feats.keypoints.yx)


def _frame_features(feats, i):
    kps = feats.keypoints
    return JFeatures(JKeypoints(*(np.asarray(f)[i] for f in kps)),
                     np.asarray(feats.descriptors)[i])


def test_match_features_equals_jax(jax_feats):
    """Identical descriptors into both matchers: identical matches."""
    cfg = jcfg.FAST_CONFIG.match
    fa = _frame_features(jax_feats, slice(0, N_FRAMES - 1))
    fb = _frame_features(jax_feats, slice(1, N_FRAMES))

    def to_torch(f):
        return Features(Keypoints(*(torch.tensor(a) for a in f.keypoints)),
                        torch.tensor(f.descriptors))

    got = match_features(to_torch(fa), to_torch(fb), FAST_CONFIG.match)
    for b in range(N_FRAMES - 1):
        want = jax_match(jax.tree_util.tree_map(lambda a: jnp.asarray(a[b]), fa),
                         jax.tree_util.tree_map(lambda a: jnp.asarray(a[b]), fb),
                         cfg)
        assert int(want.count()) > 20
        for field in ("idx_a", "idx_b", "valid"):
            np.testing.assert_array_equal(getattr(got, field)[b].numpy(),
                                          np.asarray(getattr(want, field)))
        np.testing.assert_allclose(got.distance[b].numpy(),
                                   np.asarray(want.distance), atol=1e-5)


def test_slice_matches_consecutive_frames(port_feats):
    fa = Features(Keypoints(*(f[:-1] for f in port_feats.keypoints)),
                  port_feats.descriptors[:-1])
    fb = Features(Keypoints(*(f[1:] for f in port_feats.keypoints)),
                  port_feats.descriptors[1:])
    m = match_features(fa, fb, FAST_CONFIG.match)
    assert (m.count() > 30).all()
    assert m.idx_a.dtype == torch.int32
    # matched rows are valid keypoints in both frames
    va = fa.keypoints.valid.gather(1, m.idx_a.long())
    vb = fb.keypoints.valid.gather(1, m.idx_b.long())
    assert (va | ~m.valid).all() and (vb | ~m.valid).all()


def test_synthetic_sequence_equals_jax_copy():
    kw = dict(num_frames=6, h=64, w=160, n_dots=300, step=0.4)
    a, b = SyntheticSequence(**kw), JaxSequence(**kw)
    for k in (0, 5):
        np.testing.assert_array_equal(a.frame(k), b.frame(k))
    np.testing.assert_array_equal(a.gt_poses, b.gt_poses)
    np.testing.assert_array_equal(a.info().intrinsics, b.info().intrinsics)


def test_port_imports_neither_jax_nor_the_jax_package():
    code = ("import sys, visualslam_tpu_torch, visualslam_tpu_torch.frontend\n"
            "import visualslam_tpu_torch.slam.window\n"
            "import visualslam_tpu_torch.geometry.camera\n"
            "import visualslam_tpu_torch.utils.convert\n"
            "import visualslam_tpu_torch.slam.evaluation\n"
            "import visualslam_tpu_torch.slam.tracker\n"
            "import visualslam_tpu_torch.slam.loop_closure\n"
            "import visualslam_tpu_torch.slam.global_ba\n"
            "import visualslam_tpu_torch.slam.two_view\n"
            "import visualslam_tpu_torch.geometry.sim3\n"
            "import visualslam_tpu_torch.utils.profiling\n"
            "import visualslam_tpu_torch.bench\n"
            "import visualslam_tpu_torch.cli\n"
            "import visualslam_tpu_torch.slam.checkpoint\n"
            "import visualslam_tpu_torch.slam.viz\n"
            "import visualslam_tpu_torch.io.kitti\n"
            "import visualslam_tpu_torch.io.native\n"
            "import visualslam_tpu_torch.io.photo_seq\n"
            "import visualslam_tpu_torch.io.serialization\n"
            "import visualslam_tpu_torch.utils.images\n"
            "import visualslam_tpu_torch.utils.debug\n"
            "import visualslam_tpu_torch.models.orb\n"
            "import visualslam_tpu_torch.models.harris\n"
            "import visualslam_tpu_torch.ops.fast\n"
            "import visualslam_tpu_torch.ops.harris\n"
            "import visualslam_tpu_torch.ops.nms\n"
            "import visualslam_tpu_torch.ops.resize\n"
            "import visualslam_tpu_torch.geometry.fivepoint\n"
            "import chip_smoke\n"
            "bad = [m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'visualslam_tpu' or "
            "m.startswith('visualslam_tpu.')]\n"
            "print(bad)\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True, timeout=120,
                         cwd=Path(__file__).resolve().parents[1])
    assert out.stdout.strip() == "[]", out.stdout

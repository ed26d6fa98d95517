"""The port's Harris detector and Harris frontend against the JAX package
(tests/test_harris.py's contracts on the port, then parity)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.frontend import detect_and_describe as jax_detect
from visualslam_tpu.models.harris import detect_harris as jax_harris
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.frontend import HarrisFrontend
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models.harris import detect_harris
from visualslam_tpu_torch.utils.config import HarrisConfig, SlamConfig


def checkerboard(n=96, sq=12):
    y, x = np.mgrid[0:n, 0:n]
    return (((y // sq) + (x // sq)) % 2).astype(np.float32)


def board(rng, n=96, sq=12):
    """A checkerboard whose squares take random grey levels: no two corners
    share a response."""
    y, x = np.mgrid[0:n, 0:n]
    v = rng.uniform(0.0, 1.0, (n // sq + 1, n // sq + 1))
    return v[y // sq, x // sq].astype(np.float32)


def test_harris_finds_checkerboard_corners():
    kps = detect_harris(torch.from_numpy(checkerboard())[None],
                        HarrisConfig(max_keypoints=256))
    assert int(kps.count()) >= 30
    yx = kps.yx[kps.valid].numpy()
    assert np.abs((yx + 6.0) % 12.0 - 6.0).max() <= 2.0


def test_harris_response_sorted_and_masked():
    kps = detect_harris(torch.from_numpy(checkerboard())[None],
                        HarrisConfig(max_keypoints=512))
    r, v = kps.response[0].numpy(), kps.valid[0].numpy()
    assert (np.diff(r[v]) <= 1e-6).all()
    assert (r[~v] == 0).all()
    assert v[: int(v.sum())].all()
    flat = detect_harris(torch.full((1, 64, 64), 0.5), HarrisConfig())
    assert int(flat.count()) == 0


@pytest.mark.parametrize("k", [64, 256])
def test_detect_harris_matches_jax_on_checkerboards(rng, k):
    """Random-grey checkerboards: the same keypoint count, and the corners
    (response > 1e-8) at equal positions with responses within 1e-6. A
    flat region responds 0 in exact arithmetic; the blur's ulps leave
    ~1e-26 there, and which of those noise peaks fill the last slots
    differs between the packages."""
    imgs = np.stack([board(rng), board(rng, sq=16)])
    got = detect_harris(torch.from_numpy(imgs), HarrisConfig(max_keypoints=k))
    want = jax.vmap(lambda i: jax_harris(
        i, jcfg.HarrisConfig(max_keypoints=k)))(jnp.asarray(imgs))
    np.testing.assert_array_equal(got.valid.numpy(), np.asarray(want.valid))
    corner = np.asarray(want.response) > 1e-8
    assert corner.sum() > 60
    np.testing.assert_array_equal(got.response.numpy() > 1e-8, corner)
    np.testing.assert_array_equal(got.yx.numpy()[corner],
                                  np.asarray(want.yx)[corner])
    np.testing.assert_allclose(got.response.numpy()[corner],
                               np.asarray(want.response)[corner],
                               rtol=0, atol=1e-6)
    for f in ("octave", "level", "sigma", "orientation"):
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)))


def test_harris_frontend_matches_jax():
    """The Harris frontend on rendered frames: the same keypoints (equal
    positions where no response ties) and their L2-normalised raw 16x16
    patches as descriptors, within 1e-6."""
    seq = SyntheticSequence(num_frames=2, h=120, w=160, n_dots=500)
    imgs = np.stack([seq.frame(0), seq.frame(1)]).astype(np.float32)
    cfg = jcfg.DEFAULT_CONFIG.replace(
        frontend="harris",
        harris=jcfg.DEFAULT_CONFIG.harris.replace(max_keypoints=256))
    want = jax.tree_util.tree_map(np.asarray, jax.jit(jax.vmap(
        lambda i: jax_detect(i, cfg)))(jnp.asarray(imgs)))
    got = HarrisFrontend(SlamConfig.from_json(cfg.to_json()))(
        torch.from_numpy(imgs))
    assert tuple(got.descriptors.shape) == (2, 256, 256)
    np.testing.assert_array_equal(got.keypoints.valid.numpy(),
                                  want.keypoints.valid)
    same = (got.keypoints.yx.numpy() == want.keypoints.yx).all(-1)
    assert same.mean() >= 0.99
    np.testing.assert_allclose(got.descriptors.numpy()[same],
                               want.descriptors[same], rtol=0, atol=1e-6)
    norms = np.linalg.norm(got.descriptors.numpy(), axis=-1)
    np.testing.assert_allclose(norms[got.keypoints.valid.numpy()], 1.0,
                               atol=1e-5)

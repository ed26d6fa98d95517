"""Parity of the port's extrema stage with the JAX package: the winner
planes of the fused extrema kernel's plain version and the score map of the
score kernel's plain version against the Pallas kernels (interpret mode on
CPU), the candidate selection under each extrema_impl, and localization."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.ops.extrema import detect_extrema as jax_detect_extrema
from visualslam_tpu.ops.pallas.extrema import (
    _winners_batched,
    pallas_extrema_candidates,
    pallas_extrema_score,
)
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu.utils import masked as jmasked
from visualslam_tpu_torch.ops import extrema as textrema
from visualslam_tpu_torch.ops.cuda import extrema as kext
from visualslam_tpu_torch.utils import config as tcfg
from visualslam_tpu_torch.utils import masked as tmasked

THR = 0.03
# H not a multiple of 16 (60, 37), W not a multiple of 128 (200, 90), and
# an exact tile grid (64 x 128)
SHAPES = [(60, 200), (64, 128), (37, 90)]


def _dog(seed, B, H, W):
    """DoG-like stacks quantized to 1/64: many strict extrema above the
    pre-filter, and many equal scores, so tie order is exercised."""
    r = np.random.default_rng(seed)
    return (np.round(r.standard_normal((B, 5, H, W)) * 3.0) / 64.0).astype(
        np.float32)


def _jax_cfg():
    return jcfg.FAST_CONFIG.sift.replace(extrema_impl="fused")


@pytest.mark.parametrize("H,W", SHAPES)
def test_winners_ref_equals_pallas_kernel(H, W):
    dog = _dog(H * W, 2, H, W)
    smax, srow = kext.extrema_winners_ref(torch.from_numpy(dog), THR)
    pad_h, pad_w = (-H) % 16, (-W) % 128
    x = jnp.pad(jnp.asarray(dog), ((0, 0), (0, 0), (0, pad_h), (0, pad_w)))
    rmax, rrow = _winners_batched(x, THR, 16, H, W)
    assert smax.shape == rmax.shape and srow.dtype == torch.int32
    np.testing.assert_array_equal(smax.numpy(), np.asarray(rmax))
    np.testing.assert_array_equal(srow.numpy(), np.asarray(rrow))
    assert (smax > -1e29).sum() > 20           # the test has extrema in it


def test_wrapper_runs_plain_version_on_cpu():
    dog = torch.from_numpy(_dog(1, 1, 40, 70))
    before = kext.extrema_winners.launches
    got = kext.extrema_winners(dog, THR)
    want = kext.extrema_winners_ref(dog, THR)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert kext.extrema_winners.launches == before


@pytest.mark.parametrize("H,W", SHAPES)
def test_candidates_equal_pallas(H, W):
    dog = _dog(H + W, 2, H, W)
    got = textrema.extrema_candidates(torch.from_numpy(dog), THR, 64)
    for b in range(2):
        want = pallas_extrema_candidates(jnp.asarray(dog[b]), THR, 64)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


@pytest.mark.parametrize("H,W", SHAPES)
def test_detect_extrema_matches_jax(H, W):
    # smooth the quantized stack a little so the quadratic fits converge
    dog = _dog(3 * H + W, 2, H, W)
    dog = (dog + np.roll(dog, 1, axis=3) * 0.5).astype(np.float32)
    cfg = tcfg.FAST_CONFIG.sift.replace(extrema_impl="fused")
    got = textrema.detect_extrema(torch.from_numpy(dog), cfg, capacity=96)
    lvl, y, x, off, score, valid = (t.numpy() for t in got)
    n_valid = 0
    for b in range(2):
        want = [np.asarray(t) for t in jax_detect_extrema(
            jnp.asarray(dog[b]), _jax_cfg(), capacity=96)]
        for g, w in zip((lvl[b], y[b], x[b], valid[b]), (want[0], want[1],
                                                         want[2], want[5])):
            np.testing.assert_array_equal(g, w)
        np.testing.assert_allclose(off[b], want[3], rtol=0, atol=1e-5)
        np.testing.assert_allclose(score[b], want[4], rtol=0, atol=1e-5)
        n_valid += int(valid[b].sum())
    assert n_valid > 0


# H not a multiple of 8 (the Pallas tile), W not a multiple of 128
ODD_SHAPES = [(37, 90), (61, 200), (20, 130)]


@pytest.mark.parametrize("H,W", ODD_SHAPES)
def test_score_ref_equals_pallas_kernel(H, W):
    dog = _dog(7 * H + W, 2, H, W)
    got = kext.extrema_score_ref(torch.from_numpy(dog), THR)
    assert got.shape == dog.shape and got.dtype == torch.float32
    for b in range(2):
        want = np.asarray(pallas_extrema_score(jnp.asarray(dog[b]), THR))
        # compares and |.| on both sides: the same bits
        np.testing.assert_array_equal(got[b].numpy(), want)
    assert (got > -1e29).sum() > 20            # the test has extrema in it


def test_score_wrapper_runs_plain_version_on_cpu():
    dog = torch.from_numpy(_dog(2, 2, 30, 50))
    before = kext.extrema_score.launches
    got = kext.extrema_score(dog, THR)
    assert torch.equal(got, kext.extrema_score_ref(dog, THR))
    assert kext.extrema_score.launches == before


@pytest.mark.parametrize("impl", ["pallas", "xla"])
@pytest.mark.parametrize("H,W", ODD_SHAPES[:2])
def test_detect_extrema_impls_match_jax(impl, H, W):
    dog = _dog(5 * H + W, 2, H, W)
    dog = (dog + np.roll(dog, 1, axis=3) * 0.5).astype(np.float32)
    cfg = tcfg.FAST_CONFIG.sift.replace(extrema_impl=impl)
    got = textrema.detect_extrema(torch.from_numpy(dog), cfg, capacity=96)
    lvl, y, x, off, score, valid = (t.numpy() for t in got)
    jcfg_impl = jcfg.FAST_CONFIG.sift.replace(extrema_impl=impl)
    n_valid = 0
    for b in range(2):
        want = [np.asarray(t) for t in jax_detect_extrema(
            jnp.asarray(dog[b]), jcfg_impl, capacity=96)]
        for g, w in zip((lvl[b], y[b], x[b], valid[b]), (want[0], want[1],
                                                         want[2], want[5])):
            np.testing.assert_array_equal(g, w)
        # the same cubes through the same closed-form fit in two libraries
        np.testing.assert_allclose(off[b], want[3], rtol=0, atol=1e-5)
        np.testing.assert_allclose(score[b], want[4], rtol=0, atol=1e-5)
        n_valid += int(valid[b].sum())
    assert n_valid > 0


def test_detect_extrema_pallas_and_xla_impls_agree():
    """The score kernel's plain version and the plain torch map select the
    same candidates."""
    dog = torch.from_numpy(_dog(9, 2, 45, 70))
    cfg = tcfg.FAST_CONFIG.sift
    a, b = (textrema.detect_extrema(dog, cfg.replace(extrema_impl=impl), 64)
            for impl in ("pallas", "xla"))
    for g, w in zip(a, b):
        assert torch.equal(g, w)


def test_detect_extrema_rejects_unknown_impl():
    dog = torch.zeros(1, 5, 20, 20)
    with pytest.raises(ValueError):
        textrema.detect_extrema(
            dog, tcfg.FAST_CONFIG.sift.replace(extrema_impl="scan"))


def test_top_k_select_ties_match_jax():
    scores = np.round(np.random.default_rng(5).random((3, 300)) * 8) / 8
    valid = np.random.default_rng(6).random((3, 300)) > 0.3
    for k in (10, 250, 400):          # 400 > population: padded tail
        idx, mask = tmasked.top_k_select(torch.from_numpy(scores),
                                         torch.from_numpy(valid), k)
        for b in range(3):
            ri, rm = jmasked.top_k_select(jnp.asarray(scores[b]),
                                          jnp.asarray(valid[b]), k)
            np.testing.assert_array_equal(mask[b].numpy(), np.asarray(rm))
            np.testing.assert_array_equal(idx[b].numpy()[mask[b].numpy()],
                                          np.asarray(ri)[np.asarray(rm)])


def test_block_top_k_select_matches_jax():
    r = np.random.default_rng(7)
    scores = (np.round(r.random((2, 50000)) * 64) / 64).astype(np.float32)
    valid = r.random((2, 50000)) > 0.5
    idx, mask = tmasked.block_top_k_select(torch.from_numpy(scores),
                                           torch.from_numpy(valid), 32)
    for b in range(2):
        ri, rm = jmasked.block_top_k_select(jnp.asarray(scores[b]),
                                            jnp.asarray(valid[b]), 32)
        np.testing.assert_array_equal(idx[b].numpy(), np.asarray(ri))
        np.testing.assert_array_equal(mask[b].numpy(), np.asarray(rm))


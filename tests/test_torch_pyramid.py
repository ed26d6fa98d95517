"""Parity of the PyTorch port's config, blur and pyramid with the JAX
package (visualslam_tpu), on one numpy input fed to both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.models import pyramid as jpyr
from visualslam_tpu.ops import blur as jblur
from visualslam_tpu.ops.gradients import gradients as jax_gradients
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.models import pyramid as tpyr
from visualslam_tpu_torch.ops import blur as tblur
from visualslam_tpu_torch.ops import gradients as tgrad
from visualslam_tpu_torch.utils import config as tcfg

# float32 products summed in another order than XLA's: a few ulps of the
# [0, 1] image values
ATOL = 1e-5


@pytest.mark.parametrize("name", ["DEFAULT_CONFIG", "FAST_CONFIG"])
def test_config_json_round_trip(name):
    jax_cfg = getattr(jcfg, name)
    port_cfg = tcfg.SlamConfig.from_json(jax_cfg.to_json())
    assert port_cfg.to_json() == jax_cfg.to_json()
    assert port_cfg == getattr(tcfg, name)


def test_hist_compute_dtype_is_torch():
    assert tcfg.FAST_CONFIG.sift.hist_compute_dtype is torch.bfloat16
    assert tcfg.DEFAULT_CONFIG.sift.hist_compute_dtype is None


def test_gaussian_taps_and_band_matrices_equal():
    cfg = tcfg.FAST_CONFIG.pyramid
    sigmas = tpyr.level_sigmas(cfg)
    assert sigmas == jpyr.level_sigmas(jcfg.FAST_CONFIG.pyramid)
    for s in sigmas:
        np.testing.assert_array_equal(tblur.gaussian_taps(s),
                                      jblur.gaussian_taps(s))
    key = tblur.taps_key(sigmas, cfg.truncate)
    bands = tblur.BlurBands(sigmas, cfg.truncate)
    for n in (47, 96, 200):
        ref = jblur._band_matrices(n, key, bands.radius)
        np.testing.assert_array_equal(tblur._band_matrices(n, key,
                                                           bands.radius), ref)
        np.testing.assert_array_equal(
            bands.get(n, torch.device("cpu")).numpy(), ref)


def test_blur_stack_matches_jax(rng):
    img = rng.random((2, 60, 90), dtype=np.float32)
    sigmas = tpyr.level_sigmas(tcfg.FAST_CONFIG.pyramid)
    out = tblur.blur_stack_matmul(torch.from_numpy(img),
                                  tblur.BlurBands(sigmas))
    for b in range(2):
        ref = jblur.blur_stack_matmul(jnp.asarray(img[b]), sigmas)
        np.testing.assert_allclose(out[b].numpy(), np.asarray(ref),
                                   rtol=0, atol=ATOL)


def test_gradients_match_jax(rng):
    img = rng.random((3, 40, 50), dtype=np.float32)
    dx, dy, mag, ori = tgrad.gradients(torch.from_numpy(img))
    rdx, rdy, rmag, rori = jax_gradients(jnp.asarray(img))
    np.testing.assert_array_equal(dx.numpy(), np.asarray(rdx))
    np.testing.assert_array_equal(dy.numpy(), np.asarray(rdy))
    np.testing.assert_allclose(mag.numpy(), np.asarray(rmag), atol=1e-6)
    # same dx, dy: atan2 implementations differ by an ulp of the angle
    np.testing.assert_allclose(ori.numpy(), np.asarray(rori), atol=1e-4)


def test_build_pyramid_matches_jax(rng):
    img = rng.random((2, 96, 200), dtype=np.float32)
    cfg = tcfg.FAST_CONFIG.pyramid.replace(num_octaves=2)
    ss = tpyr.build_pyramid(torch.from_numpy(img), cfg)
    assert ss.grad_level_offset == 1
    for b in range(2):
        ref = jpyr.build_pyramid(jnp.asarray(img[b]),
                                 jcfg.FAST_CONFIG.pyramid.replace(num_octaves=2))
        for o in range(2):
            for field in ("gauss", "dog", "grad_mag"):
                got = getattr(ss, field)[o][b].numpy()
                want = np.asarray(getattr(ref, field)[o])
                assert got.shape == want.shape
                np.testing.assert_allclose(got, want, rtol=0, atol=ATOL,
                                           err_msg=f"{field} octave {o}")
            # orientation where the gradient is well defined: an error e in
            # dx, dy moves the angle by ~e / mag radians
            mag = np.asarray(ref.grad_mag[o])
            d = ss.grad_ori[o][b].numpy() - np.asarray(ref.grad_ori[o])
            d = (d + 180.0) % 360.0 - 180.0
            strong = mag > 1e-3
            tol = ATOL + np.degrees(ATOL / np.maximum(mag, 1e-3))
            assert (np.abs(d)[strong] <= tol[strong]).all()

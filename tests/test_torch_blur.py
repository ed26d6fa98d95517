"""The separable blur's plain version against the Pallas kernel (interpret
mode on CPU), and the pyramid under blur_mode="pallas" against the JAX
pyramid in the same mode, on one numpy input fed to both."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.models import pyramid as jpyr
from visualslam_tpu.ops import blur as jblur
from visualslam_tpu.ops.pallas.blur import pallas_blur_stack
from visualslam_tpu.utils import config as jcfg
from visualslam_tpu_torch.models import pyramid as tpyr
from visualslam_tpu_torch.ops import blur as tblur
from visualslam_tpu_torch.ops.cuda import launch_counts
from visualslam_tpu_torch.ops.cuda.blur import blur_stack, blur_stack_ref
from visualslam_tpu_torch.utils import config as tcfg

FAST_SIGMAS = tpyr.level_sigmas(tcfg.FAST_CONFIG.pyramid)
# two 43-tap passes of float32 products summed in tap order on both sides;
# XLA may contract a product and a sum into one FMA where torch rounds
# twice: a few ulps of the [0, 1] values, well inside 1e-5 * (1 + max)
TOL = 1e-5


def _taps(sigmas):
    bands = tblur.BlurBands(sigmas)
    return bands.taps(torch.device("cpu"))


def test_tap_table_is_the_pallas_table():
    bands = tblur.BlurBands(FAST_SIGMAS)
    table = bands.taps(torch.device("cpu")).numpy()
    assert table.shape == (6, 2 * bands.radius + 1) == (6, 43)
    for s, sigma in enumerate(FAST_SIGMAS):
        t = tblur.gaussian_taps(sigma)
        r = (len(t) - 1) // 2
        np.testing.assert_array_equal(
            table[s, bands.radius - r: bands.radius + r + 1], t)
        assert table[s].sum() == pytest.approx(1.0, abs=1e-6)
    assert bands.taps(torch.device("cpu")) is bands.taps(torch.device("cpu"))


@pytest.mark.parametrize("H,W,sigmas", [
    (83, 131, (1.6, 3.2)),            # odd sizes, two radii
    (37, 90, FAST_SIGMAS),            # the FAST sigma set, 43 taps
    (12, 17, FAST_SIGMAS),            # smaller than the radius: repeated reflection
])
def test_blur_ref_matches_pallas(rng, H, W, sigmas):
    img = rng.random((2, H, W), dtype=np.float32)
    got = blur_stack_ref(torch.from_numpy(img), _taps(sigmas)).numpy()
    assert got.shape == (2, len(sigmas), H, W)
    for b in range(2):
        want = np.asarray(pallas_blur_stack(jnp.asarray(img[b]), sigmas))
        tol = TOL * (1.0 + np.abs(want).max())
        np.testing.assert_allclose(got[b], want, rtol=0, atol=tol)


def test_blur_ref_matches_matmul_blur(rng):
    """The two port blurs (separable taps vs banded products) agree to
    float32 rounding of the same sums."""
    img = torch.from_numpy(rng.random((2, 60, 90), dtype=np.float32))
    bands = tblur.BlurBands(FAST_SIGMAS)
    np.testing.assert_allclose(
        blur_stack_ref(img, bands.taps(img.device)).numpy(),
        tblur.blur_stack_matmul(img, bands).numpy(), rtol=0, atol=TOL * 2)


def test_blur_wrapper_runs_the_plain_version_on_cpu(rng):
    img = torch.from_numpy(rng.random((1, 40, 50), dtype=np.float32))
    before = launch_counts()["blur_stack"]
    assert torch.equal(blur_stack(img, _taps(FAST_SIGMAS)),
                       blur_stack_ref(img, _taps(FAST_SIGMAS)))
    assert launch_counts()["blur_stack"] == before


def test_build_pyramid_pallas_mode_matches_jax(rng):
    img = rng.random((2, 96, 200), dtype=np.float32)
    tc = tcfg.FAST_CONFIG.pyramid.replace(num_octaves=2, blur_mode="pallas")
    jc = jcfg.FAST_CONFIG.pyramid.replace(num_octaves=2, blur_mode="pallas")
    ss = tpyr.build_pyramid(torch.from_numpy(img), tc)
    for b in range(2):
        ref = jpyr.build_pyramid(jnp.asarray(img[b]), jc)
        for o in range(2):
            for field in ("gauss", "dog", "grad_mag"):
                got = getattr(ss, field)[o][b].numpy()
                want = np.asarray(getattr(ref, field)[o])
                assert got.shape == want.shape
                # octave 1 is blurred from octave 0's level, so its error
                # carries octave 0's
                np.testing.assert_allclose(got, want, rtol=0, atol=2 * TOL,
                                           err_msg=f"{field} octave {o}")


def test_build_pyramid_pallas_mode_matches_matmul_mode(rng):
    img = torch.from_numpy(rng.random((1, 64, 72), dtype=np.float32))
    cfg = tcfg.FAST_CONFIG.pyramid.replace(num_octaves=2)
    a = tpyr.build_pyramid(img, cfg.replace(blur_mode="pallas"))
    m = tpyr.build_pyramid(img, cfg)
    for o in range(2):
        np.testing.assert_allclose(a.dog[o].numpy(), m.dog[o].numpy(),
                                   rtol=0, atol=4 * TOL)


SIGMA_SETS = [FAST_SIGMAS,
              tpyr.level_sigmas(tcfg.DEFAULT_CONFIG.pyramid),
              (1.6, 3.2),
              (3.2, 1.6, 5.0, 1.2)]            # the widest sigma not last


@pytest.mark.parametrize("sigmas", SIGMA_SETS)
def test_tap_table_spans_are_the_jax_radii(sigmas):
    """Each row's non-zero span in the tap table is centred and as wide as
    the JAX package's taps for that sigma: the span the kernel finds by
    scanning the row."""
    bands = tblur.BlurBands(sigmas)
    table = bands.taps(torch.device("cpu")).numpy()
    R = bands.radius
    for s, sigma in enumerate(sigmas):
        r = (len(jblur.gaussian_taps(sigma)) - 1) // 2
        nz = np.nonzero(table[s])[0]
        assert (nz[0], nz[-1]) == (R - r, R + r)


@pytest.mark.parametrize("H,W,sigmas", [
    (37, 90, FAST_SIGMAS),
    (12, 17, FAST_SIGMAS),            # smaller than the radius
    (50, 64, (3.2, 1.6, 5.0, 1.2)),
])
def test_blur_ref_over_each_span_equals_full_table(rng, H, W, sigmas):
    """The plain version run with one sigma's non-zero span alone gives the
    bits of the full zero-padded table: the zero taps the kernel skips
    leave every finite sum as it was."""
    img = torch.from_numpy(rng.standard_normal((2, H, W)).astype(np.float32))
    taps = _taps(sigmas)
    full = blur_stack_ref(img, taps)
    for s in range(len(sigmas)):
        nz = torch.nonzero(taps[s]).flatten()
        span = taps[s:s + 1, int(nz[0]):int(nz[-1]) + 1].contiguous()
        assert torch.equal(blur_stack_ref(img, span)[:, 0], full[:, s])

"""Parity of the port's patch crop and the plain versions of its orientation
histogram / descriptor kernels with the JAX package's Pallas kernels
(interpret mode on CPU), for float32 28-row and bfloat16 32-row patches and
for a level narrower than 128 (full-row patches)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from visualslam_tpu.ops.pallas.descriptor import (
    pallas_descriptor,
    pallas_orient_hist,
)
from visualslam_tpu.ops.patches import crop_patches as jax_crop_patches
from visualslam_tpu_torch.ops.cuda import descriptor as kdesc
from visualslam_tpu_torch.ops.patches import crop_patches

K = 24
# (patch dtype, rows, tolerance): float32 patches differ from the Pallas
# kernel only by summation order; bf16 patches also by where the two
# frameworks round the bf16 x bf16 products' sums
PRECISIONS = [("float32", 28, 1e-4), ("bfloat16", 32, 1e-3)]
WIDTHS = [200, 94]          # 94 < 128: full-row patches


def _setup(W, dtype, ph, seed=0, L=3, H=96, margin=10):
    r = np.random.default_rng(seed)
    stack = r.random((L, H, W, 2), dtype=np.float32)
    stack[..., 1] *= 360.0                       # ori channel in [0, 360)
    y = r.integers(margin, H - margin, K).astype(np.float32)
    x = r.integers(margin, W - margin, K).astype(np.float32)
    lvl = r.integers(0, L, K).astype(np.int32)
    yx = np.stack([y, x], -1)
    jstack = jnp.asarray(stack).astype(jnp.dtype(dtype))
    jp = jax_crop_patches(jstack, jnp.asarray(lvl), jnp.asarray(yx), ph)
    tstack = torch.from_numpy(stack).permute(3, 0, 1, 2)[None].to(
        getattr(torch, dtype))
    tp = crop_patches(tstack, torch.from_numpy(lvl).long()[None],
                      torch.from_numpy(yx)[None], ph)
    return r, yx, jp, tuple(t[0] for t in tp)


@pytest.mark.parametrize("margin", [10, 0])    # 0: windows clamp at edges
@pytest.mark.parametrize("dtype,ph,_tol", PRECISIONS)
@pytest.mark.parametrize("W", WIDTHS)
def test_crop_patches_exact(W, dtype, ph, _tol, margin):
    _, _, (jpatch, jy0, jx0), (patch, y0, x0) = _setup(W, dtype, ph,
                                                       margin=margin)
    assert tuple(patch.shape) == (K, 2, ph, 128 if W >= 128 else W)
    np.testing.assert_array_equal(patch.float().numpy(),
                                  np.asarray(jpatch.astype(jnp.float32)))
    np.testing.assert_array_equal(y0.numpy(), np.asarray(jy0))
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jx0))
    assert y0.dtype == x0.dtype == torch.int32


@pytest.mark.parametrize("dtype,ph,tol", PRECISIONS)
@pytest.mark.parametrize("W", WIDTHS)
def test_orient_hist_ref_matches_pallas(W, dtype, ph, tol):
    r, yx, (jpatch, jy0, jx0), (patch, y0, x0) = _setup(W, dtype, ph)
    sigma = (1.5 + r.random(K) * 3.0).astype(np.float32)
    want = pallas_orient_hist(jpatch, jy0, jx0, jnp.asarray(yx),
                              jnp.asarray(sigma), 36)
    got = kdesc.orient_hist_ref(patch, y0, x0, torch.from_numpy(yx),
                                torch.from_numpy(sigma), 36)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize("dtype,ph,tol", PRECISIONS)
@pytest.mark.parametrize("W", WIDTHS)
def test_descriptor_ref_matches_pallas(W, dtype, ph, tol):
    r, yx, (jpatch, jy0, jx0), (patch, y0, x0) = _setup(W, dtype, ph)
    angle = (r.random(K) * 360.0).astype(np.float32)
    yxf = (yx + r.random((K, 2)) - 0.5).astype(np.float32)   # refined centres
    want = pallas_descriptor(jpatch, jy0, jx0, jnp.asarray(yxf),
                             jnp.asarray(angle), 4, 8)
    got = kdesc.descriptor_ref(patch, y0, x0, torch.from_numpy(yxf),
                               torch.from_numpy(angle), 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=tol,
                               atol=tol)


def test_wrappers_run_plain_versions_on_cpu():
    r, yx, _, (patch, y0, x0) = _setup(200, "bfloat16", 32)
    yx = torch.from_numpy(yx)
    sigma = torch.full((K,), 2.4)
    angle = torch.from_numpy((r.random(K) * 360.0).astype(np.float32))
    before = (kdesc.orient_hist.launches, kdesc.descriptor.launches)
    assert torch.equal(kdesc.orient_hist(patch, y0, x0, yx, sigma),
                       kdesc.orient_hist_ref(patch, y0, x0, yx, sigma))
    assert torch.equal(kdesc.descriptor(patch, y0, x0, yx, angle),
                       kdesc.descriptor_ref(patch, y0, x0, yx, angle))
    assert (kdesc.orient_hist.launches, kdesc.descriptor.launches) == before


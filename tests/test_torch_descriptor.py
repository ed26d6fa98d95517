"""Parity of the port's patch crop and the plain versions of its orientation
histogram / descriptor kernels with the JAX package's Pallas kernels
(interpret mode on CPU), for float32 28-row and bfloat16 32-row patches and
for a level narrower than 128 (full-row patches). The level-input forms
(what the kernels take: the gradient levels, and per keypoint its frame,
level and patch origin) are held equal to crop + patch form bit for bit,
and to the JAX package's crop + Pallas kernels within the same
tolerances."""

import math

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
from visualslam_tpu_torch.ops.patches import (
    crop_patches,
    patch_origins,
    rotated_grid,
)

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
    lv = _Levels(200, "bfloat16", 32)
    sigma = torch.full((lv.n,), 2.4)
    before = (kdesc.orient_hist.launches, kdesc.descriptor.launches)
    args = (lv.mag, lv.ori, lv.frame, lv.glvl, lv.y0, lv.x0)
    assert torch.equal(
        kdesc.orient_hist(*args, lv.yx, sigma, 32, True),
        kdesc.orient_hist_levels_ref(*args, lv.yx, sigma, 32, True))
    assert torch.equal(
        kdesc.descriptor(*args, lv.yx, lv.angle, 32, True),
        kdesc.descriptor_levels_ref(*args, lv.yx, lv.angle, 32, True))
    assert (kdesc.orient_hist.launches, kdesc.descriptor.launches) == before


# --- level-input forms: B frames of L gradient levels, K candidates each ---

NF = 2                      # frames


class _Levels:
    """Random (mag, ori) levels and K candidates per frame (integer centres
    `yx`, levels `glvl`) with their origins; spawned keypoints (`sp_*`):
    random candidates with refined centres up to 0.9 px off, many of which
    round to another pixel than their candidate's."""

    def __init__(self, W, dtype, ph, margin=10, seed=0, L=3, H=96):
        r = np.random.default_rng(seed)
        self.np_mag = r.random((NF, L, H, W), dtype=np.float32)
        self.np_ori = r.random((NF, L, H, W), dtype=np.float32) * 360.0
        self.np_yx = np.stack([r.integers(margin, H - margin, (NF, K)),
                               r.integers(margin, W - margin, (NF, K))],
                              -1).astype(np.float32)
        self.np_lvl = r.integers(0, L, (NF, K)).astype(np.int32)
        self.mag = torch.from_numpy(self.np_mag)
        self.ori = torch.from_numpy(self.np_ori)
        self.n = NF * K
        y0, x0 = patch_origins(H, W, torch.from_numpy(self.np_yx), ph)
        self.y0, self.x0 = y0.flatten(), x0.flatten()
        self.frame = torch.arange(NF, dtype=torch.int32).repeat_interleave(K)
        self.glvl = torch.from_numpy(self.np_lvl).flatten()
        self.yx = torch.from_numpy(self.np_yx).reshape(-1, 2)
        self.angle = torch.from_numpy(
            (r.random(self.n) * 360.0).astype(np.float32))
        # spawned keypoints: candidate rows (per frame) and refined centres
        self.cand = r.integers(0, K, (NF, K))
        rows = (self.cand + np.arange(NF)[:, None] * K).reshape(-1)
        self.sp_rows = torch.from_numpy(rows)
        self.sp_yx = (self.yx[self.sp_rows] + torch.from_numpy(
            r.uniform(-0.9, 0.9, (self.n, 2)).astype(np.float32)))
        self.dtype, self.ph = dtype, ph

    def stack(self):
        """The [B, 2, L, H, W] stack crop_patches cuts, in the patch dtype."""
        return torch.stack([self.mag, self.ori], 1).to(
            getattr(torch, self.dtype))

    def sp(self, t):
        return t[self.sp_rows].contiguous()


@pytest.mark.parametrize("margin", [10, 0])
@pytest.mark.parametrize("patch", [28, 32])
@pytest.mark.parametrize("W", WIDTHS)
def test_patch_origins_match_jax_crop(W, patch, margin):
    lv = _Levels(W, "float32", patch, margin)
    for b in range(NF):
        stack = jnp.asarray(np.stack([lv.np_mag[b], lv.np_ori[b]], -1))
        _, jy0, jx0 = jax_crop_patches(stack, jnp.asarray(lv.np_lvl[b]),
                                       jnp.asarray(lv.np_yx[b]), patch)
        np.testing.assert_array_equal(lv.y0.view(NF, K)[b].numpy(),
                                      np.asarray(jy0))
        np.testing.assert_array_equal(lv.x0.view(NF, K)[b].numpy(),
                                      np.asarray(jx0))
    if margin == 0:     # windows clamp at all four borders
        H = lv.mag.shape[2]
        assert (lv.y0 == 0).any() and (lv.y0 == H - min(patch, H)).any()


@pytest.mark.parametrize("margin", [10, 0])
@pytest.mark.parametrize("dtype,ph,_tol", PRECISIONS)
@pytest.mark.parametrize("W", WIDTHS)
def test_level_refs_equal_crop_then_patch_refs(W, dtype, ph, _tol, margin):
    """The level-input plain versions are crop_patches followed by the
    patch plain versions, bit for bit; the descriptor at the origins of
    the candidates its keypoints were spawned from."""
    lv = _Levels(W, dtype, ph, margin)
    bf16 = dtype == "bfloat16"
    patches, y0, x0 = (t.flatten(0, 1) for t in crop_patches(
        lv.stack(), lv.glvl.view(NF, K).long(), lv.yx.view(NF, K, 2), ph))
    assert torch.equal(y0, lv.y0) and torch.equal(x0, lv.x0)
    sigma = torch.linspace(1.5, 4.5, lv.n)
    got = kdesc.orient_hist_levels_ref(lv.mag, lv.ori, lv.frame, lv.glvl,
                                       lv.y0, lv.x0, lv.yx, sigma, ph, bf16)
    assert torch.equal(got, kdesc.orient_hist_ref(patches, y0, x0, lv.yx,
                                                  sigma))
    got = kdesc.descriptor_levels_ref(
        lv.mag, lv.ori, lv.sp(lv.frame), lv.sp(lv.glvl), lv.sp(lv.y0),
        lv.sp(lv.x0), lv.sp_yx, lv.angle, ph, bf16)
    want = kdesc.descriptor_ref(lv.sp(patches), lv.sp(y0), lv.sp(x0),
                                lv.sp_yx, lv.angle)
    assert torch.equal(got, want)
    # the spawned centres' own origins differ from their candidates' for
    # some keypoints: the case where recomputing the origin would be wrong
    H = lv.mag.shape[2]
    own_y0, own_x0 = patch_origins(H, W, lv.sp_yx, ph)
    assert ((own_y0 != lv.sp(lv.y0)) | (own_x0 != lv.sp(lv.x0))).any()


@pytest.mark.parametrize("margin", [10, 0])
@pytest.mark.parametrize("dtype,ph,tol", PRECISIONS)
@pytest.mark.parametrize("W", WIDTHS)
def test_level_refs_match_jax_crop_and_pallas(W, dtype, ph, tol, margin):
    lv = _Levels(W, dtype, ph, margin)
    bf16 = dtype == "bfloat16"
    sigma = torch.linspace(1.5, 4.5, lv.n)
    got_h = kdesc.orient_hist_levels_ref(lv.mag, lv.ori, lv.frame, lv.glvl,
                                         lv.y0, lv.x0, lv.yx, sigma, ph, bf16)
    got_d = kdesc.descriptor_levels_ref(
        lv.mag, lv.ori, lv.sp(lv.frame), lv.sp(lv.glvl), lv.sp(lv.y0),
        lv.sp(lv.x0), lv.sp_yx, lv.angle, ph, bf16)
    for b in range(NF):
        rows = slice(b * K, (b + 1) * K)
        stack = jnp.asarray(np.stack([lv.np_mag[b], lv.np_ori[b]],
                                     -1)).astype(jnp.dtype(dtype))
        jp, jy0, jx0 = jax_crop_patches(stack, jnp.asarray(lv.np_lvl[b]),
                                        jnp.asarray(lv.np_yx[b]), ph)
        want = pallas_orient_hist(jp, jy0, jx0, jnp.asarray(lv.np_yx[b]),
                                  jnp.asarray(sigma[rows].numpy()), 36)
        np.testing.assert_allclose(got_h[rows].numpy(), np.asarray(want),
                                   rtol=tol, atol=tol)
        c = jnp.asarray(lv.cand[b])
        want = pallas_descriptor(jp[c], jy0[c], jx0[c],
                                 jnp.asarray(lv.sp_yx[rows].numpy()),
                                 jnp.asarray(lv.angle[rows].numpy()), 4, 8)
        same = np.ones(K, bool)
        if bf16:
            same = ~_fused_rotation_moves_bf16_weight(
                lv.sp_yx[rows], lv.sp(lv.y0)[rows], lv.angle[rows], ph)
            assert same.mean() >= 0.75
        np.testing.assert_allclose(got_d[rows].numpy()[same],
                                   np.asarray(want)[same], rtol=tol, atol=tol)


def _fused_rotation_moves_bf16_weight(yx, y0, angle, ph):
    """[K] bool: keypoints where a sample's bf16-rounded y tent weight
    differs between the rotation s*gx + c*gy rounded op by op (the port,
    whose kernel matches it bit for bit) and with s*gx fused into the add
    (XLA on the CPU contracts it into an FMA in the interpreted Pallas
    kernel). There a one-ulp position difference becomes a bf16 step in a
    weight (ROADMAP.md C, first hazard), which no tolerance of 1e-3 holds;
    it is a difference between the frameworks' arithmetic, not the
    function's."""
    f = np.float32
    th = angle * (math.pi / 180.0)
    c = torch.cos(th).numpy().astype(np.float64)[:, None]
    s = torch.sin(th).numpy().astype(np.float64)[:, None]
    offs = np.arange(16) - 7.5
    gy, gx = (g.reshape(1, -1) for g in np.meshgrid(offs, offs,
                                                    indexing="ij"))
    yc = yx[:, 0].numpy()[:, None]
    o = y0.numpy().astype(np.float32)[:, None]

    def weights(ry):
        py = np.clip(f(f(yc + ry) - o), 0, ph - 1)
        i0 = np.floor(py)
        w = np.stack([np.maximum(0, 1 - np.abs(py - i0)),
                      np.maximum(0, 1 - np.abs(py - i0 - 1))])
        return torch.from_numpy(w.astype(np.float32)).bfloat16().float()

    split = weights(f(f(s * gx) + f(c * gy)))
    fused = weights(f(s * gx + f(c * gy).astype(np.float64)))
    return (split != fused).any(0).any(1).numpy()


@pytest.mark.parametrize("margin", [10, 0])
@pytest.mark.parametrize("W", WIDTHS)
def test_staged_boxes_hold_every_weighted_tap(W, margin):
    """Every patch tap with a non-zero weight lies in the box the kernel
    stages (a tap outside it would be read from the level instead)."""
    lv = _Levels(W, "bfloat16", 32, margin)
    ph, pw = 32, (128 if W >= 128 else W)
    offs = torch.arange(16, dtype=torch.float32) - 8
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    orient = lv.yx[:, None, None, :] + torch.stack([gy, gx], -1)[None]
    desc = rotated_grid(lv.sp_yx, lv.angle, 16)
    for coords, yx, y0, x0, angle in (
            (orient, lv.yx, lv.y0, lv.x0, None),
            (desc, lv.sp_yx, lv.sp(lv.y0), lv.sp(lv.x0), lv.angle)):
        r0, c0, nr, nc = kdesc.staged_boxes(yx, y0, x0, angle, ph, pw)
        assert (nr <= 24).all() and (nc <= 24).all()
        # a one-hot patch per tap row / column: its tent weights
        py = (coords[..., 0].reshape(lv.n, -1) - y0[:, None].float()
              ).clamp(0, ph - 1)
        px = (coords[..., 1].reshape(lv.n, -1) - x0[:, None].float()
              ).clamp(0, pw - 1)
        for p, lo, n, size in ((py, r0, nr, ph), (px, c0, nc, pw)):
            taps = torch.arange(size, dtype=torch.float32)
            hit = ((1.0 - (p[..., None] - taps).abs()) > 0).any(1)  # [K, n]
            inside = ((taps[None] >= lo[:, None])
                      & (taps[None] < (lo + n)[:, None]))
            assert not (hit & ~inside).any()

"""The benchmark's frames: a textured corridor and anisotropic splats seen
from a camera on a strafe rectangle, rendered on the card.

A PyTorch copy of the arithmetic of the port's `io/synthetic.py`
(`SyntheticSequence` with `trajectory="loop"`): the scene's random draws
come from `numpy.random.default_rng(seed)` in the same order, the
corridor is raycast per pixel and the splats are added on an 11x11
stencil, in float32 and float64 where the original computes in them. The
splats' sums are scattered with PyTorch's deterministic algorithms, so one
seed gives the same frames on every run. The ground-truth path comes from
the same arithmetic, on the host.
"""

from __future__ import annotations

import numpy as np
import torch

TILE = 64.0             # world units spanned by one texture tile
PLANES = ((1, 10.0, 0, 2), (0, 18.0, 1, 2), (0, -18.0, 1, 2))


class World:
    """The scene of one seed (the configuration's `scene_seed`) and the
    strafe rectangle through it.

    frames_per_lap: frames of one circuit (4 q: forward, right, back,
    left, q frames each); frame k sees what frame k + frames_per_lap sees.
    """

    def __init__(self, seed: int, h: int, w: int, n_dots: int, step: float,
                 frames_per_lap: int):
        rng = np.random.default_rng(seed)
        self.h, self.w = h, w
        self.step = step
        self.q = max(frames_per_lap // 4, 1)
        self.tex = self._make_texture(rng, 512)
        f = 0.6 * w
        self.intrinsics = np.array([f, f, w / 2, h / 2], np.float32)
        self.X = rng.uniform([-30, -15, 15], [30, 15, 60], (n_dots, 3))
        self.amp = (rng.uniform(0.3, 0.85, n_dots)
                    * rng.choice([-1.0, 1.0], n_dots)).astype(np.float32)
        self.rad = rng.uniform(1.5, 4.0, n_dots).astype(np.float32)
        self.ecc = rng.uniform(1.0, 2.5, n_dots).astype(np.float32)
        theta = rng.uniform(0, np.pi, n_dots).astype(np.float32)
        self.cos_t = np.cos(theta)
        self.sin_t = np.sin(theta)

    @staticmethod
    def _make_texture(rng, n: int) -> list:
        """Six octaves of value noise (8..256 cells a tile), as drawn by
        the original."""
        octaves = []
        amp = 1.0
        for res in (8, 16, 32, 64, 128, 256):
            octaves.append((rng.normal(size=(res, res)).astype(np.float32),
                            amp))
            amp *= 0.78
        norm = 0.38 / sum(a for _, a in octaves)
        return [(g, a * norm * 3.0) for g, a in octaves]

    # -- the path ------------------------------------------------------

    def centers(self, n: int) -> np.ndarray:
        """[n, 3] camera centers of frames 0..n-1 (float64), the
        ground truth; the camera keeps its heading (identity rotation)."""
        q = self.q
        width = min(6.0, 0.2 * q)
        steps = np.zeros((n, 3))
        p = np.arange(n) % (4 * q)
        steps[p < q, 2] = self.step
        steps[(p >= q) & (p < 2 * q), 0] = width / q
        steps[(p >= 2 * q) & (p < 3 * q), 2] = -self.step
        steps[p >= 3 * q, 0] = -width / q
        steps[0] = 0.0
        out = np.zeros((n, 3))
        for k in range(1, n):       # the original's order of sums
            out[k] = out[k - 1] + steps[k]
        return out

    # -- rendering -----------------------------------------------------

    def _background(self, C: torch.Tensor) -> torch.Tensor:
        """[B, H, W] float32 corridor for cameras at centers C [B, 3]
        (float32, identity rotation)."""
        dev = C.device
        fx, fy, cx, cy = (float(v) for v in self.intrinsics)
        vv, uu = torch.meshgrid(torch.arange(self.h, dtype=torch.float32,
                                             device=dev),
                                torch.arange(self.w, dtype=torch.float32,
                                             device=dev), indexing="ij")
        d = (((uu - cx) / fx).reshape(-1), ((vv - cy) / fy).reshape(-1),
             torch.ones(self.h * self.w, device=dev))
        B, P = C.shape[0], self.h * self.w
        eps = 1e-9
        best = torch.full((B, P), float("inf"), device=dev)
        val = torch.zeros((B, P), device=dev)
        for axis, off, ta, tb in PLANES:
            da = d[axis].expand(B, P)
            s = (off - C[:, axis:axis + 1]) / torch.where(
                da.abs() < eps, torch.full_like(da, eps), da)
            hit = (s > 0.5) & (s < best)
            pa = C[:, ta:ta + 1] + s * d[ta]
            pb = C[:, tb:tb + 1] + s * d[tb]
            smp = self._sample_tex(pa, pb, s / float(np.float32(fx)))
            val = torch.where(hit, smp, val)
            best = torch.where(hit, s, best)
        return (0.5 + val).reshape(B, self.h, self.w)

    def _sample_tex(self, a, b, footprint):
        out = torch.zeros_like(a)
        for g, amp in self.tex:
            res = g.shape[0]
            cell = TILE / res
            wgt = torch.clamp(cell / torch.clamp(footprint, min=1e-6) - 0.5,
                              0.0, 1.0)
            gt = torch.from_numpy(g).to(a.device).reshape(-1)
            ua = a * (res / TILE)
            ub = b * (res / TILE)
            i0 = torch.floor(ua).long()
            j0 = torch.floor(ub).long()
            fa = ua - i0
            fb = ub - j0
            i0 = i0 % res
            j0 = j0 % res
            i1 = (i0 + 1) % res
            j1 = (j0 + 1) % res

            def at(i, j):
                return gt[i * res + j]

            out = out + np.float32(amp) * wgt * (
                at(i0, j0) * (1 - fa) * (1 - fb) + at(i1, j0) * fa * (1 - fb)
                + at(i0, j1) * (1 - fa) * fb + at(i1, j1) * fa * fb)
        return out

    def _splat(self, img: torch.Tensor, centers: np.ndarray) -> None:
        """Add the visible splats of cameras at `centers` [B, 3] into img
        [B, H, W] (float64 arithmetic, float32 sums), then clip."""
        dev = img.device
        B = img.shape[0]
        fx, fy, cx, cy = (float(v) for v in self.intrinsics)
        X = torch.from_numpy(self.X).to(dev)
        Cc = torch.from_numpy(np.ascontiguousarray(centers)).to(dev)
        Xc = X[None] - Cc[:, None, :]                    # R = I, t = -C
        z = Xc[..., 2]
        u = fx * Xc[..., 0] / torch.clamp(z, min=1e-6) + cx
        v = fy * Xc[..., 1] / torch.clamp(z, min=1e-6) + cy
        sel = ((z > 1.0) & (u > -8) & (u < self.w + 8) & (v > -8)
               & (v < self.h + 8))                       # [B, n]
        yy, xx = torch.meshgrid(torch.arange(-5, 6, device=dev),
                                torch.arange(-5, 6, device=dev),
                                indexing="ij")
        yy, xx = yy.double(), xx.double()
        iu = torch.round(u)
        iv = torch.round(v)
        rad20 = torch.from_numpy(self.rad * np.float32(20.0)).to(dev)
        r_px = torch.clamp(rad20.double() / z, min=0.8)
        dy = yy + (iv - v)[..., None, None]              # [B, n, 11, 11]
        dx = xx + (iu - u)[..., None, None]
        ct = torch.from_numpy(self.cos_t).to(dev).double()[:, None, None]
        st = torch.from_numpy(self.sin_t).to(dev).double()[:, None, None]
        a = dx * ct + dy * st
        bm = -dx * st + dy * ct
        ecc2 = torch.from_numpy(self.ecc ** 2).to(dev).double()[:, None,
                                                                None]
        amp = torch.from_numpy(self.amp).to(dev).double()[:, None, None]
        g = amp * torch.exp(-(a * a + bm * bm * ecc2)
                            / (2 * r_px[..., None, None] ** 2))
        g = torch.where(sel[..., None, None], g, torch.zeros_like(g))
        ys = torch.clamp(iv.long()[..., None, None] + yy.long(), 0,
                         self.h - 1)
        xs = torch.clamp(iu.long()[..., None, None] + xx.long(), 0,
                         self.w - 1)
        frame = torch.arange(B, device=dev)[:, None, None, None].expand_as(ys)
        flat = img.view(-1)
        idx = (frame * (self.h * self.w) + ys * self.w + xs).reshape(-1)
        flat.index_put_((idx,), g.reshape(-1).float(), accumulate=True)
        any_sel = sel.any(dim=1)[:, None, None]
        img.copy_(torch.where(any_sel, img.clamp(0.02, 1.0), img))

    def render(self, ids, device, batch: int = 16) -> torch.Tensor:
        """uint8 frames [n, H, W] of path positions `ids` on `device`."""
        ids = np.asarray(list(ids))
        centers = self.centers(int(ids.max()) + 1)[ids]
        out = torch.empty((len(ids), self.h, self.w), dtype=torch.uint8,
                          device=device)
        was = torch.are_deterministic_algorithms_enabled()
        torch.use_deterministic_algorithms(True)
        try:
            for k in range(0, len(ids), batch):
                c = centers[k:k + batch]
                C32 = torch.from_numpy(c.astype(np.float32)).to(device)
                img = self._background(C32).contiguous()
                self._splat(img, c)
                out[k:k + batch] = torch.clamp(img * 255.0, 0,
                                               255).to(torch.uint8)
        finally:
            torch.use_deterministic_algorithms(was)
        return out

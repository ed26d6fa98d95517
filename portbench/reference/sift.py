"""Plain SIFT (Lowe 2004) at a configuration's settings, to judge the
keypoints and descriptors that a frontend returned.

Written from the definitions, not from the program: per octave a Gaussian
scale space (every level blurred from the octave's base at the absolute
sigma base_sigma * 2^(l / s), taps out to truncate * sigma, symmetric
borders; the next octave's base every second sample of level s), the DoG
as differences of adjacent levels, and gradients as central differences
with replicated borders. At a keypoint's sample it states what SIFT makes
of it:

- whether the sample is a keypoint: a strict extremum among its 26 DoG
  neighbours above half the contrast threshold, whose one-step quadratic
  fit is solvable with every offset within 1.5, passes the edge test
  tr^2 r < det (r + 1)^2 and interpolates to a contrast above the
  threshold;
- its refined position: the sample plus the fitted offset clamped to
  +-0.5 (scale, y, x);
- its orientations: the peaks (local maxima at or above peak_ratio of the
  highest, at most max_orientations, parabolically refined) of a 36-bin
  histogram of the orientations of the 16 x 16 samples at offsets -8..7
  about it, weighted by their magnitude and a Gaussian of
  orientation_sigma_scale times its scale centred on the window's centre
  (offset -0.5), each sample split linearly between its two nearest bins;
- its descriptor at a given position and angle: a 16 x 16 grid of unit
  steps rotated by the angle about the position, bilinear samples
  (edge-clamped) of magnitude and orientation, the magnitude times a
  Gaussian of sigma 8 about the grid's centre, the orientation relative
  to the angle split linearly between 8 bins of its 4 x 4 sample region;
  normalised, clamped at descriptor_clamp and normalised again.

Under hist_compute "bf16" the magnitude and orientation samples that
enter the histograms are rounded to bfloat16 first, as the configuration
states. `Precision` says how this computes: the judge in float64, the
control in float32 with TF32 products and the histograms' inputs one step
below the configuration's (float8 for bfloat16).
"""

from __future__ import annotations

import contextlib
import functools
import math
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

WIN = 16                # side of the orientation and descriptor windows
DESC_SIGMA = 8.0        # the descriptor's spatial Gaussian
ORI_TOL = 0.5           # degrees between an angle and a judged orientation
POS_TOL = 0.01          # octave samples between two refined positions
DESC_TOL = 0.03         # between two descriptors' elements


@dataclass(frozen=True)
class Precision:
    dtype: torch.dtype          # of the scale space and everything after
    tf32: bool                  # TF32 products (the blurs)
    hist: torch.dtype | None    # histogram inputs rounded to this

    @staticmethod
    def judge(sift: dict) -> "Precision":
        return Precision(torch.float64, False,
                         torch.bfloat16 if sift["hist_compute"] == "bf16"
                         else None)

    @staticmethod
    def control(sift: dict) -> "Precision":
        return Precision(torch.float32, True,
                         torch.float8_e4m3fn if sift["hist_compute"] == "bf16"
                         else torch.bfloat16)


@contextlib.contextmanager
def matmul_tf32(on: bool):
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


def gaussian_taps(sigma: float, truncate: float) -> np.ndarray:
    r = max(1, int(math.ceil(truncate * sigma)))
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    return k / k.sum()


@functools.lru_cache(maxsize=64)
def blur_matrix(n: int, sigma: float, truncate: float) -> np.ndarray:
    """[n, n] float64: out = in @ M blurs an axis of n samples with
    symmetric borders (the edge sample repeats)."""
    k = gaussian_taps(sigma, truncate)
    r = (len(k) - 1) // 2
    src = np.pad(np.arange(n), r, mode="symmetric")
    M = np.zeros((n, n))
    for j in range(n):
        np.add.at(M[:, j], src[j:j + 2 * r + 1], k)
    return M


def blur(img: torch.Tensor, sigma: float, truncate: float,
         prec: Precision) -> torch.Tensor:
    """[..., H, W] blurred along x, then along y."""
    H, W = img.shape[-2:]
    dev = img.device
    mx = torch.from_numpy(blur_matrix(W, sigma, truncate)).to(dev, prec.dtype)
    my = torch.from_numpy(blur_matrix(H, sigma, truncate)).to(dev, prec.dtype)
    with matmul_tf32(prec.tf32):
        return my.T @ (img.to(prec.dtype) @ mx)


class Octave(NamedTuple):
    gauss: torch.Tensor     # [L, H, W]
    dog: torch.Tensor       # [L - 1, H, W]
    mag: torch.Tensor       # [L, H, W]
    ori: torch.Tensor       # [L, H, W] degrees in [0, 360)


def scale_space(frame: torch.Tensor, pyr: dict,
                prec: Precision) -> list:
    """The octaves of one frame [H, W] in [0, 1]."""
    if pyr["initial_upsample"] or pyr["assumed_blur"] != 0.0:
        raise NotImplementedError("a 2x base or an assumed blur")
    s = pyr["scale_samples"]
    sigmas = [pyr["base_sigma"] * 2.0 ** (l / s) for l in range(s + 3)]
    base = frame.to(prec.dtype)
    out = []
    for _ in range(pyr["num_octaves"]):
        g = torch.stack([blur(base, sg, pyr["truncate"], prec)
                         for sg in sigmas])
        px = torch.cat([g[..., :, :1], g, g[..., :, -1:]], dim=-1)
        py = torch.cat([g[..., :1, :], g, g[..., -1:, :]], dim=-2)
        dx = px[..., :, 2:] - px[..., :, :-2]
        dy = py[..., 2:, :] - py[..., :-2, :]
        ori = torch.rad2deg(torch.atan2(dy, dx))
        out.append(Octave(g, g[1:] - g[:-1], torch.sqrt(dx * dx + dy * dy),
                          torch.where(ori < 0, ori + 360.0, ori)))
        base = g[s, ::2, ::2]
    return out


def rounded(x: torch.Tensor, dtype) -> torch.Tensor:
    return x if dtype is None else x.to(dtype).to(x.dtype)


class Fit(NamedTuple):
    is_kp: torch.Tensor     # [N] bool
    offset: torch.Tensor    # [N, 3] (ds, dy, dx), clamped to +-0.5


def fit(dog: torch.Tensor, l, y, x, sift: dict) -> Fit:
    """The keypoint test and refinement at DoG samples (l, y, x) [N]."""
    D, H, W = dog.shape
    inside = (l >= 1) & (l <= D - 2) & (y >= 1) & (y <= H - 2) & \
        (x >= 1) & (x <= W - 2)
    l, y, x = (torch.where(inside, a, torch.ones_like(a)) for a in (l, y, x))
    r = torch.arange(-1, 2, device=dog.device)
    c = dog[(l[:, None, None, None] + r[:, None, None]),
            (y[:, None, None, None] + r[:, None]),
            (x[:, None, None, None] + r)]                      # [N, 3, 3, 3]
    d0 = c[:, 1, 1, 1]
    nb = torch.cat([c.reshape(-1, 27)[:, :13], c.reshape(-1, 27)[:, 14:]], 1)
    extremum = ((d0[:, None] > nb).all(1) | (d0[:, None] < nb).all(1)) & \
        (d0.abs() > 0.5 * sift["contrast_threshold"])
    g = 0.5 * torch.stack([c[:, 2, 1, 1] - c[:, 0, 1, 1],
                           c[:, 1, 2, 1] - c[:, 1, 0, 1],
                           c[:, 1, 1, 2] - c[:, 1, 1, 0]], -1)
    hss = c[:, 2, 1, 1] + c[:, 0, 1, 1] - 2 * d0
    hyy = c[:, 1, 2, 1] + c[:, 1, 0, 1] - 2 * d0
    hxx = c[:, 1, 1, 2] + c[:, 1, 1, 0] - 2 * d0
    hsy = 0.25 * (c[:, 2, 2, 1] - c[:, 2, 0, 1] - c[:, 0, 2, 1] + c[:, 0, 0, 1])
    hsx = 0.25 * (c[:, 2, 1, 2] - c[:, 2, 1, 0] - c[:, 0, 1, 2] + c[:, 0, 1, 0])
    hyx = 0.25 * (c[:, 1, 2, 2] - c[:, 1, 2, 0] - c[:, 1, 0, 2] + c[:, 1, 0, 0])
    Hm = torch.stack([torch.stack([hss, hsy, hsx], -1),
                      torch.stack([hsy, hyy, hyx], -1),
                      torch.stack([hsx, hyx, hxx], -1)], -2)
    solvable = torch.linalg.det(Hm).abs() > 1e-12
    eye = torch.eye(3, dtype=Hm.dtype, device=Hm.device)
    z = -torch.linalg.solve(torch.where(solvable[:, None, None], Hm, eye), g)
    contrast = d0 + 0.5 * (g * z).sum(-1)
    r_edge = sift["edge_r"]
    tr, det2 = hxx + hyy, hxx * hyy - hyx * hyx
    edge_ok = (det2 > 0) & (tr * tr * r_edge < det2 * (r_edge + 1.0) ** 2)
    is_kp = (inside & extremum & solvable & (z.abs() <= 1.5).all(-1)
             & edge_ok & (contrast.abs() > sift["contrast_threshold"]))
    return Fit(is_kp, z.clamp(-0.5, 0.5))


def soft_hist(values, weights, nbins: int) -> torch.Tensor:
    """[N, P] values in degrees, weights -> [N, nbins]: each value split
    linearly between the two bins whose centres ((b + 0.5) * 360 / nbins)
    are nearest, circularly."""
    p = values * (nbins / 360.0) - 0.5
    b0 = torch.floor(p)
    w1 = p - b0
    b0 = torch.remainder(b0.long(), nbins)
    out = torch.zeros(values.shape[0], nbins, dtype=weights.dtype,
                      device=weights.device)
    out.scatter_add_(1, b0, weights * (1.0 - w1))
    out.scatter_add_(1, (b0 + 1) % nbins, weights * w1)
    return out


def orientations(mag, ori, y, x, sigma, sift: dict, prec: Precision):
    """(angles [N, P] degrees, valid [N, P]) of the histogram about
    integer samples (y, x) [N] of one level's mag, ori [H, W]."""
    H, W = mag.shape
    d = torch.arange(-(WIN // 2), WIN // 2, device=mag.device)
    yy = (y[:, None, None] + d[:, None]).clamp(0, H - 1)
    xx = (x[:, None, None] + d).clamp(0, W - 1)
    m = rounded(mag[yy, xx], prec.hist)
    o = rounded(ori[yy, xx], prec.hist)
    w = (d.to(mag.dtype) + 0.5) ** 2
    w = torch.exp(-(w[:, None] + w) / (2.0 * sigma[:, None, None] ** 2))
    n = sift["num_orientation_bins"]
    hist = soft_hist(o.reshape(len(y), -1), (m * w).reshape(len(y), -1), n)
    left, right = hist.roll(1, 1), hist.roll(-1, 1)
    top = hist.amax(1, keepdim=True)
    ok = (hist > left) & (hist >= right) & \
        (hist >= sift["orientation_peak_ratio"] * top) & (top > 0)
    score = torch.where(ok, hist, torch.full_like(hist, -math.inf))
    vals, bins = torch.sort(score, dim=1, descending=True, stable=True)
    P = sift["max_orientations"]
    vals, bins = vals[:, :P], bins[:, :P]
    hc, hl, hr = (t.gather(1, bins) for t in (hist, left, right))
    den = hl - 2.0 * hc + hr
    delta = torch.where(den.abs() > 1e-12,
                        0.5 * (hl - hr) / torch.where(den == 0, 1.0, den),
                        torch.zeros_like(den)).clamp(-0.5, 0.5)
    ang = torch.remainder((bins + 0.5 + delta) * (360.0 / n), 360.0)
    return ang, torch.isfinite(vals)


def bilinear(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
    """Edge-clamped bilinear samples of img [H, W] at float (yy, xx)."""
    H, W = img.shape
    yy, xx = yy.clamp(0, H - 1), xx.clamp(0, W - 1)
    y0, x0 = torch.floor(yy).long(), torch.floor(xx).long()
    y1, x1 = (y0 + 1).clamp(max=H - 1), (x0 + 1).clamp(max=W - 1)
    wy, wx = yy - y0, xx - x0
    return ((1 - wy) * (1 - wx) * img[y0, x0] + (1 - wy) * wx * img[y0, x1]
            + wy * (1 - wx) * img[y1, x0] + wy * wx * img[y1, x1])


def descriptors(mag, ori, yx, angle, sift: dict,
                prec: Precision) -> torch.Tensor:
    """[N, width^2 * bins] normalised descriptors at positions yx [N, 2]
    (octave samples) and angles [N] (degrees) of one level's mag, ori."""
    N = len(yx)
    dt = mag.dtype
    g = torch.arange(WIN, dtype=dt, device=mag.device) - (WIN - 1) / 2.0
    gy, gx = g[:, None].expand(WIN, WIN), g[None, :].expand(WIN, WIN)
    th = torch.deg2rad(angle.to(dt))
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    yy = s * gx + c * gy + yx[:, 0, None, None].to(dt)
    xx = c * gx - s * gy + yx[:, 1, None, None].to(dt)
    m = bilinear(rounded(mag, prec.hist), yy, xx)
    o = bilinear(rounded(ori, prec.hist), yy, xx)
    rel = torch.remainder(o - angle.to(dt)[:, None, None], 360.0)
    w = m * torch.exp(-(gy * gy + gx * gx) / (2.0 * DESC_SIGMA ** 2))
    width, nb = sift["descriptor_width"], sift["descriptor_bins"]
    cell = WIN // width

    def regions(a):      # [N, 16, 16] -> [N * regions, cell * cell]
        a = a.reshape(N, width, cell, width, cell).permute(0, 1, 3, 2, 4)
        return a.reshape(N * width * width, cell * cell)

    d = soft_hist(regions(rel), regions(w), nb).reshape(N, -1)
    if sift["descriptor_norm"] != "l2":
        raise NotImplementedError(sift["descriptor_norm"])
    d = d / torch.linalg.vector_norm(d, dim=1, keepdim=True).clamp_min(1e-12)
    d = d.clamp(max=sift["descriptor_clamp"])
    return d / torch.linalg.vector_norm(d, dim=1, keepdim=True).clamp_min(
        1e-12)


class Side(NamedTuple):
    """What one side (the program, or the control) says of each keypoint
    of one frame: [N] fields and [N, D] descriptors."""

    octave: torch.Tensor
    level: torch.Tensor     # DoG level of the sample
    yx: torch.Tensor        # [N, 2] refined, octave samples
    ds: torch.Tensor        # refined scale offset
    angle: torch.Tensor     # degrees
    is_kp: torch.Tensor     # bool
    desc: torch.Tensor


def program_side(kp, desc, pyr: dict) -> Side:
    """The valid keypoints of one frame of a frontend's Features (fields
    without the frame axis)."""
    v = kp.valid.bool()
    o = kp.octave[v].long()
    lvl = kp.level[v].long()
    k = 2.0 ** (1.0 / pyr["scale_samples"])
    base = (2.0 ** o.double()) * pyr["base_sigma"]
    ds = torch.log(kp.sigma[v].double() / base) / math.log(k) - lvl
    return Side(o, lvl, kp.yx_oct[v].double(), ds,
                kp.orientation[v].double(), torch.ones_like(o, dtype=torch.bool),
                desc[v].double())


def _candidates(u: torch.Tensor) -> torch.Tensor:
    """[N, 2] integer samples a refined coordinate came from: its nearest,
    or both neighbours where it lies half-way (an offset clamped to 0.5)."""
    f = torch.floor(u)
    half = (u - f) == 0.5
    near = torch.round(u)
    return torch.stack([torch.where(half, f, near),
                        torch.where(half, f + 1, near)], -1).long()


def samples(side: Side, octaves: list, sift: dict):
    """(y, x, fit) of each keypoint's integer sample under the judge's
    octaves: of the candidates its refined position admits, the one the
    judge finds a keypoint at, nearest the side's position."""
    cy, cx = _candidates(side.yx[:, 0]), _candidates(side.yx[:, 1])
    N = len(side.level)
    best_y, best_x = cy[:, 0].clone(), cx[:, 0].clone()
    best_kp = torch.zeros(N, dtype=torch.bool, device=cy.device)
    best_off = torch.zeros(N, 3, dtype=torch.float64, device=cy.device)
    best_gap = torch.full((N,), math.inf, dtype=torch.float64,
                          device=cy.device)
    for iy in range(2):
        for ix in range(2):
            y, x = cy[:, iy], cx[:, ix]
            kp = torch.zeros_like(best_kp)
            off = torch.zeros_like(best_off)
            for o, oc in enumerate(octaves):
                sel = side.octave == o
                if sel.any():
                    f = fit(oc.dog, side.level[sel], y[sel], x[sel], sift)
                    kp[sel], off[sel] = f.is_kp, f.offset.double()
            pos = torch.stack([y, x], -1) + off[:, 1:]
            gap = (pos - side.yx).abs().amax(-1)
            gap = torch.where(kp, gap, gap + 1e6)
            better = gap < best_gap
            best_y = torch.where(better, y, best_y)
            best_x = torch.where(better, x, best_x)
            best_kp = torch.where(better, kp, best_kp)
            best_off = torch.where(better[:, None], off, best_off)
            best_gap = torch.where(better, gap, best_gap)
    return best_y, best_x, Fit(best_kp, best_off)


def judge(frame: torch.Tensor, side: Side, cfg: dict) -> dict:
    """The numbers of one frame [H, W] uint8: not_kp (share of keypoints
    where the side's verdict differs from the judge's), pos_gap (largest
    gap of a refined position, in octave samples, where both find a
    keypoint), pos_miss (share of those where it exceeds POS_TOL),
    ori_miss (share of those whose angle lies more than ORI_TOL degrees
    from every orientation the judge finds), desc_gap (largest gap of one
    descriptor element against the judge's descriptor at the side's
    position and angle) and desc_miss (share of keypoints whose
    descriptor has a gap above DESC_TOL). An orientation sample that
    straddles 0 / 360 degrees interpolates to anywhere between, as the
    configuration's frontend samples orientations, so a rounding that
    turns one gradient across +x moves a descriptor element by up to
    ~0.06 in a keypoint or two: desc_gap swings with it, desc_miss does
    not."""
    pyr, sift = cfg["pyramid"], cfg["sift"]
    prec = Precision.judge(sift)
    octaves = scale_space(frame.double() / 255.0, pyr, prec)
    y, x, f = samples(side, octaves, sift)
    both = f.is_kp & side.is_kp
    pos = torch.stack([y, x], -1).double() + f.offset[:, 1:]
    gap = torch.cat([(f.offset[:, :1] - side.ds[:, None]).abs(),
                     (pos - side.yx).abs()], -1).amax(-1)
    miss = torch.zeros_like(both)
    ref_desc = torch.zeros_like(side.desc)
    k = 2.0 ** (1.0 / pyr["scale_samples"])
    for o, oc in enumerate(octaves):
        for lvl in range(1, pyr["scale_samples"] + 1):
            sel = (side.octave == o) & (side.level == lvl)
            if not sel.any():
                continue
            sigma = (sift["orientation_sigma_scale"] * pyr["base_sigma"]
                     * k ** (lvl + f.offset[sel, 0]))
            ang, ok = orientations(oc.mag[lvl], oc.ori[lvl], y[sel], x[sel],
                                   sigma, sift, prec)
            dist = (side.angle[sel, None] - ang).abs() % 360.0
            dist = torch.where(ok, torch.minimum(dist, 360.0 - dist),
                               torch.full_like(dist, math.inf))
            miss[sel] = dist.amin(1) > ORI_TOL
            ref_desc[sel] = descriptors(oc.mag[lvl], oc.ori[lvl],
                                        side.yx[sel], side.angle[sel], sift,
                                        prec)
    n, nb = max(len(both), 1), max(int(both.sum()), 1)
    dgap = (side.desc - ref_desc).abs().amax(-1)
    return {
        "sift.not_kp": float((f.is_kp != side.is_kp).sum()) / n,
        "sift.pos_gap": float(gap[both].max()) if both.any() else 0.0,
        "sift.pos_miss": float(((gap > POS_TOL) & both).sum()) / nb,
        "sift.ori_miss": float((miss & both).sum()) / nb,
        "sift.desc_gap": float(dgap.max()) if len(dgap) else 0.0,
        "sift.desc_miss": float((dgap > DESC_TOL).sum()) / n,
    }


def control_side(frame: torch.Tensor, prog: Side, cfg: dict) -> Side:
    """The control in the program's place: at the program's keypoints'
    samples, the keypoint test, refinement, orientation (of its peaks, the
    one nearest the program's) and descriptor computed in the precision
    below the configuration's."""
    pyr, sift = cfg["pyramid"], cfg["sift"]
    prec = Precision.control(sift)
    judge_oct = scale_space(frame.double() / 255.0, pyr,
                            Precision.judge(sift))
    y, x, _ = samples(prog, judge_oct, sift)
    del judge_oct
    octaves = scale_space(frame.float() / 255.0, pyr, prec)
    N = len(y)
    is_kp = torch.zeros(N, dtype=torch.bool, device=y.device)
    off = torch.zeros(N, 3, dtype=torch.float64, device=y.device)
    angle = prog.angle.clone()
    desc = torch.zeros_like(prog.desc)
    k = 2.0 ** (1.0 / pyr["scale_samples"])
    for o, oc in enumerate(octaves):
        sel_o = prog.octave == o
        if sel_o.any():
            f = fit(oc.dog, prog.level[sel_o], y[sel_o], x[sel_o], sift)
            is_kp[sel_o], off[sel_o] = f.is_kp, f.offset.double()
        for lvl in range(1, pyr["scale_samples"] + 1):
            sel = sel_o & (prog.level == lvl)
            if not sel.any():
                continue
            sigma = (sift["orientation_sigma_scale"] * pyr["base_sigma"]
                     * k ** (lvl + off[sel, 0]))
            ang, ok = orientations(oc.mag[lvl], oc.ori[lvl], y[sel], x[sel],
                                   sigma.float(), sift, prec)
            ang = ang.double()
            dist = (prog.angle[sel, None] - ang).abs() % 360.0
            dist = torch.where(ok, torch.minimum(dist, 360.0 - dist),
                               torch.full_like(dist, math.inf))
            angle[sel] = ang.gather(1, dist.argmin(1, keepdim=True))[:, 0]
            yx = torch.stack([y[sel], x[sel]], -1).double() + off[sel, 1:]
            desc[sel] = descriptors(oc.mag[lvl], oc.ori[lvl], yx,
                                    angle[sel], sift, prec).double()
    yx = torch.stack([y, x], -1).double() + off[:, 1:]
    return Side(prog.octave, prog.level, yx, off[:, 0], angle, is_kp, desc)

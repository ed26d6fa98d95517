"""Plain ORB (Rublee et al. 2011) at a configuration's settings, to judge
the keypoints and descriptors that a frontend returned.

Written from the definitions, not from the program. Level l of the
pyramid is the frame resized to round(H / f^l) x round(W / f^l) by
jax.image.resize's antialiased linear filter (the triangle kernel widened
by the scale, its weights per output sample normalised). On a level it
states what ORB makes of a keypoint at an integer sample:

- whether it is one: a FAST corner (at least `fast_arc` contiguous pixels
  of the 16-pixel Bresenham circle of radius 3 all brighter, or all
  darker, than the centre by more than the threshold; 3 pixels from every
  border), whose Harris response (k 0.04, the gradients of a sigma-1
  blur summed over 3 x 3 boxes) is at least that of every corner among
  its 8 neighbours;
- its angle: the intensity centroid's over the disc of radius
  patch_size // 2 of the patch_size window about it (the window held
  inside the level);
- its descriptor at a given angle: steered BRIEF, `brief_pairs` point
  pairs drawn from N(0, patch_size / 5) (numpy's generator seeded with
  brief_seed, clipped to patch_size // 2 - 1) rotated by the angle,
  bilinear samples (edge-clamped) of a sigma-2 blur, bit i set where the
  pair's first sample is darker than its second, 32 bits a word from the
  lowest.

Blurs take taps out to 4 sigma with symmetric borders. The judge computes
in float64; the control in float32 with TF32 products.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from portbench.reference.sift import bilinear, blur_matrix, matmul_tf32

CIRCLE = ((-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
          (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2),
          (-3, -1))
HARRIS_K = 0.04
ANGLE_TOL = 0.01        # degrees between two angles


@functools.lru_cache(maxsize=64)
def resize_weights(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out]: jax.image.resize's "linear" weights, antialiased,
    in its float32 arithmetic (sample (j + 0.5) * n_in / n_out - 0.5)."""
    f32 = np.float32
    inv = f32(n_in / n_out)
    ks = max(inv, f32(1.0))
    pos = ((np.arange(n_out, dtype=f32) + f32(0.5)) * inv
           - f32(0.5)).astype(f32)
    x = np.abs(pos[None, :] - np.arange(n_in, dtype=f32)[:, None]) / ks
    w = np.maximum(f32(0.0), f32(1.0) - x).astype(np.float64)
    w = w / np.where(w.sum(0) > 0, w.sum(0), 1.0)
    inside = (pos >= -0.5) & (pos <= n_in - 0.5)
    return np.where(inside[None, :], w, 0.0)


def level_sizes(h: int, w: int, orb: dict) -> list:
    return [(int(round(h / orb["scale_factor"] ** l)),
             int(round(w / orb["scale_factor"] ** l)))
            for l in range(orb["num_levels"])]


def _mat(a: np.ndarray, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(a).to(like.device, like.dtype)


def level_image(frame: torch.Tensor, h: int, w: int, tf32: bool):
    H, W = frame.shape
    if (h, w) == (H, W):
        return frame
    with matmul_tf32(tf32):
        out = frame @ _mat(resize_weights(W, w), frame)
        return _mat(resize_weights(H, h), frame).T @ out


def blur(img: torch.Tensor, sigma: float, tf32: bool) -> torch.Tensor:
    H, W = img.shape
    with matmul_tf32(tf32):
        return _mat(blur_matrix(H, sigma, 4.0), img).T @ (
            img @ _mat(blur_matrix(W, sigma, 4.0), img))


def _shift(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    H, W = img.shape
    iy = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    ix = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img[iy][:, ix]


def keypoint_map(img: torch.Tensor, orb: dict, tf32: bool) -> torch.Tensor:
    """[h, w] bool: FAST corners that are Harris peaks among corners."""
    H, W = img.shape
    diff = torch.stack([_shift(img, dy, dx) for dy, dx in CIRCLE]) - img
    thr, arc = orb["fast_threshold"], orb["fast_arc"]
    corner = torch.zeros_like(img, dtype=torch.bool)
    for m in (diff > thr, diff < -thr):
        run = torch.cat([m, m[:arc - 1]])
        for a in range(16):
            corner |= run[a:a + arc].all(0)
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    corner &= (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    b = blur(img, 1.0, tf32)
    px = torch.cat([b[:, :1], b, b[:, -1:]], 1)
    py = torch.cat([b[:1], b, b[-1:]], 0)
    dx, dy = px[:, 2:] - px[:, :-2], py[2:] - py[:-2]

    def box(a):
        a = F.pad(a[None, None], (1, 1, 1, 1), mode="replicate")[0, 0]
        return sum(a[i:i + H, j:j + W] for i in range(3) for j in range(3))

    sxx, syy, sxy = box(dx * dx), box(dy * dy), box(dx * dy)
    R = sxx * syy - sxy * sxy - HARRIS_K * (sxx + syy) ** 2
    score = torch.where(corner, R, torch.full_like(R, -math.inf))
    top = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return corner & (score >= top)


def centroid_angle(img: torch.Tensor, y, x, patch: int) -> torch.Tensor:
    """Degrees in [0, 360) of the intensity centroids at (y, x) [N]."""
    H, W = img.shape
    r = patch // 2
    y0 = (y - r).clamp(0, H - patch)
    x0 = (x - r).clamp(0, W - patch)
    d = torch.arange(patch, device=img.device)
    win = img[(y0[:, None, None] + d[:, None]), (x0[:, None, None] + d)]
    o = (d - r).to(img.dtype)
    disc = (o[:, None] ** 2 + o ** 2 <= r * r).to(img.dtype)
    m01 = (win * (o[:, None] * disc)).sum((1, 2))
    m10 = (win * (o * disc)).sum((1, 2))
    a = torch.rad2deg(torch.atan2(m01, m10))
    return torch.where(a < 0, a + 360.0, a)


@functools.lru_cache(maxsize=8)
def brief_pattern(seed: int, pairs: int, patch: int) -> np.ndarray:
    """[pairs, 2, 2] (dy, dx) offsets of each pair's two points."""
    rng = np.random.default_rng(seed)
    r = patch // 2 - 1
    pts = rng.normal(0.0, patch / 5.0, size=(pairs, 2, 2))
    return np.clip(pts, -r, r).astype(np.float32)


def brief(smooth: torch.Tensor, y, x, angle, orb: dict) -> torch.Tensor:
    """[N, pairs / 32] int64 words (each holding 32 bits)."""
    pat = _mat(brief_pattern(orb["brief_seed"], orb["brief_pairs"],
                             orb["patch_size"]).astype(np.float64), smooth)
    th = torch.deg2rad(angle.to(smooth.dtype))
    c, s = torch.cos(th)[:, None, None], torch.sin(th)[:, None, None]
    dy, dx = pat[..., 0], pat[..., 1]
    yy = s * dx + c * dy + y.to(smooth.dtype)[:, None, None]
    xx = c * dx - s * dy + x.to(smooth.dtype)[:, None, None]
    v = bilinear(smooth, yy, xx)                          # [N, pairs, 2]
    bits = (v[..., 0] < v[..., 1]).to(torch.int64)
    N, P = bits.shape
    shifts = torch.arange(32, device=bits.device)
    return (bits.reshape(N, P // 32, 32) << shifts).sum(-1)


def words(desc: torch.Tensor) -> torch.Tensor:
    """Packed uint32 descriptor words as int64 (CUDA indexes no uint32)."""
    return desc.view(torch.int32).to(torch.int64) & 0xFFFFFFFF


class Side(NamedTuple):
    """What one side says of each keypoint of one frame: [N] fields and
    [N, words] int64 descriptors."""

    level: torch.Tensor
    y: torch.Tensor
    x: torch.Tensor
    angle: torch.Tensor     # degrees
    is_kp: torch.Tensor
    desc: torch.Tensor


def program_side(kp, desc) -> Side:
    v = kp.valid.bool()
    yx = torch.round(kp.yx_oct[v]).long()
    return Side(kp.level[v].long(), yx[:, 0], yx[:, 1],
                kp.orientation[v].double(),
                torch.ones(int(v.sum()), dtype=torch.bool,
                           device=v.device), words(desc.view(torch.int32)[v]))


def _levels(frame: torch.Tensor, orb: dict, dtype, tf32: bool):
    img = frame.to(dtype) / 255.0
    H, W = img.shape
    for l, (h, w) in enumerate(level_sizes(H, W, orb)):
        yield l, level_image(img, h, w, tf32)


def _popcount(x: torch.Tensor) -> torch.Tensor:
    n = torch.zeros_like(x)
    for _ in range(32):
        n += x & 1
        x = x >> 1
    return n


def judge(frame: torch.Tensor, side: Side, cfg: dict) -> dict:
    """The numbers of one frame [H, W] uint8: not_kp (share of keypoints
    where the side's verdict differs from the judge's), angle_gap (largest
    gap of an angle, degrees), angle_miss (share of angles more than
    ANGLE_TOL off) and bit_share (share of the descriptors'
    bits that differ from the judge's BRIEF at the side's angle)."""
    orb = cfg["orb"]
    is_kp = torch.zeros_like(side.is_kp)
    angle = torch.zeros_like(side.angle)
    desc = torch.zeros_like(side.desc)
    for l, img in _levels(frame, orb, torch.float64, False):
        sel = side.level == l
        if not sel.any():
            continue
        y, x = side.y[sel], side.x[sel]
        h, w = img.shape
        inside = (y >= 0) & (y < h) & (x >= 0) & (x < w)
        yc, xc = y.clamp(0, h - 1), x.clamp(0, w - 1)
        is_kp[sel] = keypoint_map(img, orb, False)[yc, xc] & inside
        angle[sel] = centroid_angle(img, yc, xc, orb["patch_size"])
        desc[sel] = brief(blur(img, 2.0, False), yc, xc, side.angle[sel],
                          orb)
    gap = (side.angle - angle).abs() % 360.0
    gap = torch.minimum(gap, 360.0 - gap)
    n = max(len(is_kp), 1)
    bits = float(_popcount(side.desc ^ desc).sum())
    return {"orb.not_kp": float((is_kp != side.is_kp).sum()) / n,
            "orb.angle_gap": float(gap.max()) if len(gap) else 0.0,
            "orb.angle_miss": float((gap > ANGLE_TOL).sum()) / n,
            "orb.bit_share": bits / max(desc.numel() * 32, 1)}


def control_side(frame: torch.Tensor, prog: Side, cfg: dict) -> Side:
    """The control in the program's place: at the program's keypoints,
    the keypoint test, angle and descriptor (at its own angle) in float32
    with TF32 products, the precision below the configuration's."""
    orb = cfg["orb"]
    is_kp = torch.zeros_like(prog.is_kp)
    angle = prog.angle.clone()
    desc = torch.zeros_like(prog.desc)
    for l, img in _levels(frame, orb, torch.float32, True):
        sel = prog.level == l
        if not sel.any():
            continue
        h, w = img.shape
        y, x = prog.y[sel].clamp(0, h - 1), prog.x[sel].clamp(0, w - 1)
        is_kp[sel] = keypoint_map(img, orb, True)[y, x]
        a = centroid_angle(img, y, x, orb["patch_size"])
        angle[sel] = a.double()
        desc[sel] = brief(blur(img, 2.0, True), y, x, a, orb)
    return Side(prog.level, prog.y, prog.x, angle, is_kp, desc)

"""ORB frontend: oriented FAST + rotated BRIEF over an image pyramid
(visualslam_tpu/models/orb.py), batched over frames.

  - a 1.2x level pyramid, each level resized from the frame with
    jax.image.resize's antialiased linear filter (ops/resize.py)
  - dense FAST-9 mask per level (ops/fast.py), Harris re-ranking on a
    sigma-1 blur (cfg.harris_ranking), 3x3 peaks, block top-k per level
  - orientation by intensity centroid over a circular 31-px patch
  - rBRIEF: 256 seeded Gaussian point pairs (`brief_pattern`, numpy, the
    JAX package's draws), steered by the keypoint angle and sampled
    bilinearly on a sigma-2 blur, packed to [K, 8] uint32
  - the levels merged by a global top-k of the scores

The moment weights and the BRIEF pattern are built once per device
(`utils.constants.device_constant`), as are the blurs' taps and pads.
Bit packing runs in int64 and the words are kept as int32 until the merge
is done, then viewed as uint32 (torch has few kernels for uint32:
ops/distance.packed_words).

`detect_and_describe_orb_jit(img, cfg)` is the JAX package's jitted ORB
frontend: on the card one captured CUDA graph per shape key and cfg
(`utils.graphs.GraphProgram`, seedless; the descriptors keep their uint32
type) over the process's resize weights for the device; on the CPU the
function run eagerly.
"""

from __future__ import annotations

import numpy as np
import torch

from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.blur import gaussian_blur
from visualslam_tpu_torch.ops.cuda import KERNELS
from visualslam_tpu_torch.ops.distance import pack_words
from visualslam_tpu_torch.ops.fast import fast_score_map
from visualslam_tpu_torch.ops.gradients import central_diff
from visualslam_tpu_torch.ops.harris import harris_response
from visualslam_tpu_torch.ops.nms import window_peaks
from visualslam_tpu_torch.ops.patches import (
    extract_patches,
    sample_bilinear,
    sample_bilinear_patches,
)
from visualslam_tpu_torch.ops.resize import ResizeWeights, resize_linear
from visualslam_tpu_torch.utils.config import OrbConfig
from visualslam_tpu_torch.utils.constants import device_constant
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.masked import block_top_k_select, top_k_select

BRIEF_PATCH = 44    # crop side covering the rotated BRIEF offsets


def brief_pattern(cfg: OrbConfig) -> np.ndarray:
    """[pairs, 2, 2] (dy, dx) sampling offsets, Gaussian(0, patch / 5),
    clipped inside the patch, deterministic from cfg.brief_seed."""
    rng = np.random.default_rng(cfg.brief_seed)
    sigma = cfg.patch_size / 5.0
    r = cfg.patch_size // 2 - 1
    pts = rng.normal(0.0, sigma, size=(cfg.brief_pairs, 2, 2))
    return np.clip(pts, -r, r).astype(np.float32)


def _centroid_weights(patch: int) -> tuple:
    """(y, x, mask) moment weights of a circular patch, float32."""
    r = patch // 2
    ys, xs = np.mgrid[-r: r + 1, -r: r + 1]
    mask = (ys ** 2 + xs ** 2 <= r ** 2).astype(np.float32)
    return ((ys * mask).astype(np.float32), (xs * mask).astype(np.float32),
            mask)


def level_sizes(h: int, w: int, cfg: OrbConfig) -> list:
    """[(h_l, w_l)] of the levels: int(round(H / 1.2^l))."""
    return [(h, w) if l == 0 else
            (int(round(h / cfg.scale_factor ** l)),
             int(round(w / cfg.scale_factor ** l)))
            for l in range(cfg.num_levels)]


def level_capacities(cfg: OrbConfig) -> list:
    """Keypoints per level: proportional to the level's area, at least 32."""
    areas = [1.0 / (cfg.scale_factor ** (2 * l))
             for l in range(cfg.num_levels)]
    total = sum(areas)
    return [max(32, int(round(cfg.max_keypoints * a / total)))
            for a in areas]


def _detect_level(img: torch.Tensor, cfg: OrbConfig, k: int):
    """One level [B, h, w] -> (yx [B, k, 2], score [B, k], angle [B, k]
    degrees, valid [B, k])."""
    is_corner, fast_score = fast_score_map(img, cfg.fast_threshold,
                                           cfg.fast_arc)
    if cfg.harris_ranking:
        dx, dy = central_diff(gaussian_blur(img, 1.0))
        score = harris_response(dx, dy, 3, 0.04)
    else:
        score = fast_score
    score = torch.where(is_corner, score,
                        torch.full((), float("-inf"), device=img.device))
    peaks = window_peaks(score, 3, float("-inf")) & is_corner
    B, _, W = img.shape
    flat = score.reshape(B, -1)
    idx, mask = block_top_k_select(flat, peaks.reshape(B, -1), k)
    yx = torch.stack([idx // W, idx % W], dim=-1).float()

    # intensity-centroid orientation (moments over a circular patch)
    wy, wx = (device_constant(("orb_centroid", cfg.patch_size, i),
                              img.device,
                              lambda i=i: _centroid_weights(cfg.patch_size)[i])
              for i in (0, 1))
    patches = extract_patches(img, yx, cfg.patch_size)
    m01 = (patches * wy).sum(dim=(-2, -1))
    m10 = (patches * wx).sum(dim=(-2, -1))
    angle = torch.rad2deg(torch.atan2(m01, m10))
    angle = torch.where(angle < 0, angle + 360.0, angle)
    score = torch.where(mask, flat.gather(1, idx),
                        torch.zeros((), device=img.device))
    return yx, score, angle, mask


def _describe_level(img: torch.Tensor, yx: torch.Tensor, angle: torch.Tensor,
                    cfg: OrbConfig) -> torch.Tensor:
    """Steered BRIEF bits of one level -> [B, K, pairs / 32] words, int32
    with the uint32 words' bits."""
    smoothed = gaussian_blur(img, 2.0)
    pat = device_constant(("brief", cfg.brief_seed, cfg.patch_size,
                           cfg.brief_pairs), img.device,
                          lambda: brief_pattern(cfg))           # [P, 2, 2]
    theta = torch.deg2rad(angle)
    c = torch.cos(theta)[..., None, None]
    s = torch.sin(theta)[..., None, None]
    dy, dx = pat[..., 0], pat[..., 1]                           # [P, 2]
    rdx = c * dx - s * dy                                       # [B, K, P, 2]
    rdy = s * dx + c * dy
    coords = torch.stack([rdy, rdx], dim=-1) + yx[:, :, None, None, :]
    B, H, W = smoothed.shape
    if min(H, W) >= BRIEF_PATCH:
        lvl0 = torch.zeros(yx.shape[:2], dtype=torch.int32, device=yx.device)
        vals = sample_bilinear_patches(smoothed[:, None], lvl0, yx, coords,
                                       BRIEF_PATCH)             # [B, K, P, 2]
    else:
        vals = sample_bilinear(smoothed, coords)
    bits = (vals[..., 0] < vals[..., 1]).to(torch.int64)        # [B, K, P]
    K, P = bits.shape[1:]
    shifts = torch.arange(32, dtype=torch.int64, device=img.device)
    words = (bits.reshape(B, K, P // 32, 32) << shifts).sum(dim=-1)
    return pack_words(words)


def detect_and_describe_orb(img: torch.Tensor, cfg: OrbConfig,
                            resize: ResizeWeights | None = None) -> Features:
    """ORB on [B, H, W] float frames in [0, 1] -> Features [B, K, ...] with
    [B, K, pairs / 32] uint32 descriptors. `resize` holds the level
    resizes' weights across calls."""
    B, H, W = img.shape
    per_level = level_capacities(cfg)
    results = []
    for l, (h, w) in enumerate(level_sizes(H, W, cfg)):
        scale = cfg.scale_factor ** l
        level_img = img if l == 0 else resize_linear(img, h, w, resize)
        yx, score, angle, mask = _detect_level(level_img, cfg, per_level[l])
        desc = _describe_level(level_img, yx, angle, cfg)
        results.append((yx * scale, yx, score, angle, mask, desc, l, scale))

    score_all = torch.cat([r[2] for r in results], dim=1)
    valid_all = torch.cat([r[4] for r in results], dim=1)
    idx, mask = top_k_select(score_all, valid_all, cfg.max_keypoints)

    def take(i):
        cat = torch.cat([r[i] for r in results], dim=1)
        b = torch.arange(B, device=img.device)[:, None]
        return cat[b, idx]

    level = torch.cat([torch.full_like(r[2], r[6], dtype=torch.int32)
                       for r in results], dim=1).gather(1, idx)
    sigma = torch.cat([torch.full_like(r[2], r[7]) for r in results],
                      dim=1).gather(1, idx)
    m2 = mask[..., None]
    zero = torch.zeros((), device=img.device)
    kps = Keypoints(
        yx=take(0) * m2,
        yx_oct=take(1) * m2,
        octave=torch.where(mask, level, 0),
        level=torch.where(mask, level, 0),
        sigma=torch.where(mask, sigma, zero),
        orientation=torch.where(mask, take(3), zero),
        response=torch.where(mask, score_all.gather(1, idx), zero),
        valid=mask,
    )
    desc = take(5)
    desc = torch.where(m2, desc, torch.zeros_like(desc)).view(torch.uint32)
    return Features(kps, desc)


_RESIZE: dict = {}


def _detect_and_describe_orb(x: tuple, cfg: tuple) -> Features:
    img, = x
    resize = _RESIZE.get(img.device)
    if resize is None:
        resize = _RESIZE[img.device] = ResizeWeights()
    return detect_and_describe_orb(img, cfg[0], resize)


_ORB = GraphProgram(_detect_and_describe_orb, seeded=False)


def detect_and_describe_orb_jit(img: torch.Tensor, cfg: OrbConfig) -> Features:
    """detect_and_describe_orb as one captured graph per shape key and
    cfg; the features are the caller's (copies of the graph's outputs)."""
    return _ORB((img,), (cfg, KERNELS))


detect_and_describe_orb_jit.program = _ORB

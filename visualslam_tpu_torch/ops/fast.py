"""FAST segment-test corners (visualslam_tpu/ops/fast.py), batched over
frames.

The 16-pixel Bresenham circle test for every pixel at once: 16 shifted
copies of the frame (edge-replicated), a brighter / darker mask per ring
pixel, and the "contiguous arc of >= N" test as a circular sliding-window
sum over the ring.
"""

from __future__ import annotations

import numpy as np
import torch

# Bresenham circle of radius 3: 16 (dy, dx) offsets in clockwise order.
CIRCLE16 = np.array([
    (-3, 0), (-3, 1), (-2, 2), (-1, 3),
    (0, 3), (1, 3), (2, 2), (3, 1),
    (3, 0), (3, -1), (2, -2), (1, -3),
    (0, -3), (-1, -3), (-2, -2), (-3, -1),
], dtype=np.int32)


def _shifted(img: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """out[..., y, x] = img[..., clamp(y + dy), clamp(x + dx)]."""
    H, W = img.shape[-2:]
    iy = (torch.arange(H, device=img.device) + dy).clamp(0, H - 1)
    ix = (torch.arange(W, device=img.device) + dx).clamp(0, W - 1)
    return img.index_select(-2, iy).index_select(-1, ix)


def _has_arc(mask: torch.Tensor, arc: int) -> torch.Tensor:
    """[16, ...] ring masks -> [...] True where `arc` consecutive ring
    pixels (circularly) are set."""
    m = mask.float()
    mm = torch.cat([m, m[: arc - 1]], dim=0)
    csum = torch.cat([torch.zeros_like(mm[:1]), torch.cumsum(mm, dim=0)])
    return (csum[arc:] - csum[:-arc]).amax(dim=0) >= arc


def fast_score_map(img: torch.Tensor, threshold: float, arc: int = 9):
    """FAST-`arc` corner mask and score of [B, H, W] frames.

    Returns (is_corner [B, H, W] bool, score [B, H, W] float32): the score
    is the sum over the qualifying ring pixels of |difference| - threshold,
    summed in ring order. A 3 px border is never a corner."""
    ring = torch.stack([_shifted(img, int(dy), int(dx))
                        for dy, dx in CIRCLE16])               # [16, B, H, W]
    diff = ring - img[None]
    brighter = diff > threshold
    darker = diff < -threshold
    is_corner = _has_arc(brighter, arc) | _has_arc(darker, arc)
    term = torch.where(brighter | darker, diff.abs() - threshold,
                       torch.zeros((), device=img.device))
    score = term[0]
    for t in term[1:]:
        score = score + t
    H, W = img.shape[-2:]
    yy = torch.arange(H, device=img.device)[:, None]
    xx = torch.arange(W, device=img.device)[None, :]
    interior = (yy >= 3) & (yy < H - 3) & (xx >= 3) & (xx < W - 3)
    return is_corner & interior, score

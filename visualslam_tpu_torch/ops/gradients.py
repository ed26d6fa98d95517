"""Image gradients, magnitude and orientation (visualslam_tpu/ops/gradients.py).

Unscaled [-1, 0, 1] central differences with a replicated border, then
magnitude and orientation in degrees [0, 360).
"""

from __future__ import annotations

import math

import torch


def central_diff(img: torch.Tensor):
    """(dx, dy) central differences of [..., H, W], replicate border."""
    px = torch.cat([img[..., :, :1], img, img[..., :, -1:]], dim=-1)
    py = torch.cat([img[..., :1, :], img, img[..., -1:, :]], dim=-2)
    return px[..., :, 2:] - px[..., :, :-2], py[..., 2:, :] - py[..., :-2, :]


def magnitude_orientation(dx: torch.Tensor, dy: torch.Tensor):
    """(magnitude, orientation in degrees [0, 360))."""
    mag = torch.sqrt(dx * dx + dy * dy)
    ori = torch.atan2(dy, dx) * (180.0 / math.pi)
    return mag, torch.where(ori < 0.0, ori + 360.0, ori)


def gradients(img: torch.Tensor):
    """Full gradient product set: (dx, dy, mag, ori_degrees)."""
    dx, dy = central_diff(img)
    mag, ori = magnitude_orientation(dx, dy)
    return dx, dy, mag, ori

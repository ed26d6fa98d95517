"""Resize ops for pyramid construction (visualslam_tpu/ops/resize.py).

The 2x linear upsample of the DEFAULT profile is not ported yet (ROADMAP.md
A.9); the FAST profile starts its pyramid from the frame itself.
"""

from __future__ import annotations

import torch


def downsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """0.5x nearest downsample of [..., H, W]: every second pixel."""
    return img[..., ::2, ::2]

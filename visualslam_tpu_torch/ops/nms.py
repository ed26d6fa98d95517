"""Non-maximum suppression (visualslam_tpu/ops/nms.py): a sliding window
max (`F.max_pool2d` at stride 1, padded with -inf as `reduce_window` pads)
and the peaks that equal it (plateaus survive)."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def window_max(x: torch.Tensor, window: int) -> torch.Tensor:
    """Sliding window max over the last two axes, same shape."""
    lead, (H, W) = x.shape[:-2], x.shape[-2:]
    out = F.max_pool2d(x.reshape(-1, 1, H, W), window, stride=1,
                       padding=window // 2)
    return out.reshape(lead + (H, W))


def window_peaks(x: torch.Tensor, window: int,
                 threshold: float = 0.0) -> torch.Tensor:
    """Mask of the window-local maxima (x >= its window max) above
    `threshold`."""
    return (x >= window_max(x, window)) & (x > threshold)

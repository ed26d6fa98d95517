"""Pinhole camera model (visualslam_tpu/geometry/camera.py). Intrinsics
are a [4] tensor [fx, fy, cx, cy]."""

from __future__ import annotations

import torch


def project(X: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Camera-frame points [..., 3] -> pixel coords [..., 2] (x, y)."""
    z = X[..., 2]
    return torch.stack([intr[0] * X[..., 0] / z + intr[2],
                        intr[1] * X[..., 1] / z + intr[3]], -1)


def unproject(uv: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixel coords [..., 2] (x, y) -> normalized camera rays [..., 3]
    with z = 1."""
    x = (uv[..., 0] - intr[2]) / intr[0]
    y = (uv[..., 1] - intr[3]) / intr[1]
    return torch.stack([x, y, torch.ones_like(x)], -1)


def normalized(uv: torch.Tensor, intr: torch.Tensor) -> torch.Tensor:
    """Pixel coords -> normalized image plane coords [..., 2]."""
    return unproject(uv, intr)[..., :2]

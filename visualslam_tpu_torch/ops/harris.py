"""Harris corner response (visualslam_tpu/ops/harris.py)."""

from __future__ import annotations

import torch

from visualslam_tpu_torch.ops.blur import box_filter


def _fma(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c rounded once to float32 (the product is exact in float64)."""
    return (a.double() * b.double() + c.double()).float()


def harris_response(dx: torch.Tensor, dy: torch.Tensor, window: int = 3,
                    k: float = 0.04) -> torch.Tensor:
    """R = det(M) - k tr(M)^2 with M the window-summed structure tensor of
    the gradients dx, dy [..., H, W] float32. The two multiply-adds are
    rounded once each, as XLA fuses them: det = fma(ixx, iyy, -ixy^2),
    R = fma(-k, tr^2, det); so R equals the JAX package's bit for bit."""
    ixx = box_filter(dx * dx, window)
    iyy = box_filter(dy * dy, window)
    ixy = box_filter(dx * dy, window)
    det = _fma(ixx, iyy, -(ixy * ixy))
    tr = ixx + iyy
    return _fma(torch.full_like(tr, -k), tr * tr, det)

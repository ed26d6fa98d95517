"""All-pairs descriptor distances (visualslam_tpu/ops/distance.py)."""

from __future__ import annotations

import torch


def l2sq_distance_matrix(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Squared L2 distances. a: [..., Ka, D], b: [..., Kb, D] ->
    [..., Ka, Kb] float32, as |a|^2 + |b|^2 - 2 a.b clamped at 0. One
    float32 product (TF32 off, frontend.detect_and_describe): TF32's
    rounding of a.b would flip near-tied ratio tests."""
    a = a.float()
    b = b.float()
    ab = a @ b.transpose(-1, -2)
    na = (a * a).sum(dim=-1, keepdim=True)
    nb = (b * b).sum(dim=-1, keepdim=True)
    return (na + nb.transpose(-1, -2) - 2.0 * ab).clamp_min(0.0)

"""Epipolar geometry (visualslam_tpu/geometry/epipolar.py): DLT
triangulation. The 8-point solver, Sampson error and pose recovery come
with the host tracker's two-view init (ROADMAP.md A.7).

Conventions: x in normalized camera coords; (R, t) maps points from the
camera-1 frame to the camera-2 frame, X2 = R X1 + t.
"""

from __future__ import annotations

import torch

from visualslam_tpu_torch.utils.precision import f32_matmul

_EPS = 1e-12


def triangulate(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                x2: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) triangulation in camera-1 frame: the eigenvector of the
    smallest eigenvalue of each point's 4x4 normal matrix. R, t: relative
    pose; x1, x2: [N, 2] normalized coords. Returns X [N, 3].

    The reference runs at float32 matmul precision; so does this (TF32
    off, utils/precision.f32_matmul). On CUDA, `eigh` of a near-degenerate
    normal matrix (a point near infinity) may pick another eigenvector
    than the CPU's: compare such points only where both accept them."""
    f32_matmul()
    zeros = torch.zeros((3, 1), dtype=R.dtype, device=R.device)
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device), zeros], 1)
    P2 = torch.cat([R, t[:, None]], 1)                       # [3, 4]

    def dlt_rows(P, x):
        # rows: x * P3 - P1 ; y * P3 - P2
        return torch.stack([x[..., 0, None] * P[2] - P[0],
                            x[..., 1, None] * P[2] - P[1]], -2)

    A = torch.cat([dlt_rows(P1, x1), dlt_rows(P2, x2)], -2)  # [N, 4, 4]
    M = A.transpose(-1, -2) @ A
    _, evecs = torch.linalg.eigh(M)
    Xh = evecs[..., 0]                                      # [N, 4]
    one = torch.ones_like(Xh[..., 3])
    Xh = Xh * torch.where(Xh[..., 3] < 0, -one, one)[..., None]
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(w.abs() < _EPS,
                                     torch.full_like(w, _EPS), w)

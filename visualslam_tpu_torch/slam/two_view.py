"""Two-view initialization (visualslam_tpu/slam/two_view.py): detect and
describe two frames, match, RANSAC essential, pose + structure."""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualslam_tpu_torch.frontend import detect_and_describe
from visualslam_tpu_torch.geometry.camera import normalized
from visualslam_tpu_torch.geometry.ransac import estimate_relative_pose
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Matches
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.config import SlamConfig


class TwoViewResult(NamedTuple):
    R: torch.Tensor          # [3, 3] rotation camera1 -> camera2
    t: torch.Tensor          # [3] unit translation (up to scale)
    points: torch.Tensor     # [M, 3] triangulated points in camera-1 frame
    matches: Matches         # the matched keypoint pairs
    inliers: torch.Tensor    # [M] bool epipolar + cheirality inliers
    num_inliers: torch.Tensor


def two_view_from_features(fa: Features, fb: Features, intr: torch.Tensor,
                           cfg: SlamConfig,
                           gen: torch.Generator | None = None,
                           kernels: Kernels = KERNELS) -> TwoViewResult:
    m = match_features(fa, fb, cfg.match, kernels)
    x1 = normalized(fa.keypoints.yx[m.idx_a.long()].flip(-1), intr)
    x2 = normalized(fb.keypoints.yx[m.idx_b.long()].flip(-1), intr)
    R, t, X, inl, n = estimate_relative_pose(x1, x2, m.valid, cfg.ransac, gen,
                                             kernels)
    return TwoViewResult(R=R, t=t, points=X, matches=m, inliers=inl,
                         num_inliers=n)


def two_view_reconstruction(img1: torch.Tensor, img2: torch.Tensor,
                            intr: torch.Tensor, cfg: SlamConfig,
                            gen: torch.Generator | None = None,
                            kernels: Kernels = KERNELS) -> TwoViewResult:
    """Pixels to pose on an image pair ([H, W] each, uint8 or float)."""
    f = detect_and_describe(torch.stack([img1, img2]), cfg, kernels=kernels)
    fa, fb = (Features(type(f.keypoints)(*(x[i] for x in f.keypoints)),
                       f.descriptors[i]) for i in range(2))
    return two_view_from_features(fa, fb, intr, cfg, gen, kernels)

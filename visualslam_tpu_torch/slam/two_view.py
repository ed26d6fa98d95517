"""Two-view initialization (visualslam_tpu/slam/two_view.py): detect and
describe two frames, match, RANSAC essential, pose + structure.

`two_view_reconstruction_jit` is the JAX package's jitted pixels-to-pose
program: on the card one captured CUDA graph per shape key of the frontend
on both frames, the match, RANSAC, pose and triangulation, with no host
sync (utils.graphs.GraphProgram, its RANSAC generator registered with the
graph). `two_view_from_features_jit` captures the part after the frontend
the same way. On the CPU, and for the plain kernel set (whose
`torch.linalg` solvers read the host), both are the eager functions."""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualslam_tpu_torch.frontend import detect_and_describe, frontend_body
from visualslam_tpu_torch.geometry.camera import normalized
from visualslam_tpu_torch.geometry.ransac import estimate_relative_pose
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Matches
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram


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


def _split(f: Features) -> tuple:
    """Frames 0 and 1 of a batched Features."""
    return tuple(Features(type(f.keypoints)(*(x[i] for x in f.keypoints)),
                          f.descriptors[i]) for i in range(2))


def two_view_reconstruction(img1: torch.Tensor, img2: torch.Tensor,
                            intr: torch.Tensor, cfg: SlamConfig,
                            gen: torch.Generator | None = None,
                            kernels: Kernels = KERNELS) -> TwoViewResult:
    """Pixels to pose on an image pair ([H, W] each, uint8 or float)."""
    f = detect_and_describe(torch.stack([img1, img2]), cfg, kernels=kernels)
    return two_view_from_features(*_split(f), intr, cfg, gen, kernels)


def _from_features(x, cfg, gen):
    fa, fb, intr = x
    scfg, kernels = cfg
    return two_view_from_features(fa, fb, intr, scfg, gen, kernels)


_FROM_FEATURES = GraphProgram(_from_features)


def two_view_from_features_jit(fa: Features, fb: Features,
                               intr: torch.Tensor, cfg: SlamConfig,
                               seed: int | None = None,
                               kernels: Kernels = KERNELS) -> TwoViewResult:
    """two_view_from_features as one captured graph per shape key and
    (cfg, kernels): its RANSAC draws are those of
    `geometry.ransac.generator(seed)` (cfg.ransac.seed by default)."""
    seed = cfg.ransac.seed if seed is None else seed
    return _FROM_FEATURES((fa, fb, intr), (cfg, kernels), seed)


two_view_from_features_jit.program = _FROM_FEATURES


def _reconstruction(x, cfg, gen):
    img1, img2, intr = x
    scfg, kernels = cfg
    f = frontend_body((torch.stack([img1, img2]),), cfg)
    return two_view_from_features(*_split(f), intr, scfg, gen, kernels)


_RECONSTRUCTION = GraphProgram(_reconstruction)


def two_view_reconstruction_jit(img1: torch.Tensor, img2: torch.Tensor,
                                intr: torch.Tensor, cfg: SlamConfig,
                                seed: int | None = None,
                                kernels: Kernels = KERNELS) -> TwoViewResult:
    """two_view_reconstruction with a seed in place of a generator, as one
    captured graph per shape key and (cfg, kernels), pixels to pose: its
    RANSAC draws are those of `geometry.ransac.generator(seed)`
    (cfg.ransac.seed by default)."""
    seed = cfg.ransac.seed if seed is None else seed
    return _RECONSTRUCTION((img1, img2, intr), (cfg, kernels), seed)


two_view_reconstruction_jit.program = _RECONSTRUCTION

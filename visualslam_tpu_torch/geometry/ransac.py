"""Batched-hypothesis RANSAC for the essential matrix
(visualslam_tpu/geometry/ransac.py).

No early-exit loop: N hypotheses are sampled, solved (the 8-point solver,
or the five-point solver's up to 10 candidates of which each hypothesis
keeps its first best) and scored in one batched call, the first best count
wins, and one weighted 8-point refit on the winner's inliers polishes it.
Samples are Gumbel top-k over the validity mask, drawn from a
`torch.Generator` on the tensors' device.

`jax.random`'s bits cannot be drawn in torch, so the sampler is one
module-level function, `sample_indices`: a parity test replaces it with one
that replays the reference's draws.

The solvers' small eigendecompositions and SVDs go through `kernels`
(ops.cuda.KERNELS on the card: no host read, so the whole estimate captures
into one CUDA graph, slam/tracker.py's "ransac" program); the winners are
taken with index_select, since indexing by a 0-d tensor reads it on the
host.
"""

from __future__ import annotations

import torch

from visualslam_tpu_torch.geometry.epipolar import (
    eight_point,
    recover_pose,
    sampson_error,
)
from visualslam_tpu_torch.geometry.fivepoint import MAX_CANDIDATES, five_point
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.config import RansacConfig
from visualslam_tpu_torch.utils.masked import top_k


def generator(seed: int, device="cuda") -> torch.Generator:
    """A torch.Generator on `device` seeded with `seed`."""
    return torch.Generator(device=device).manual_seed(int(seed))


def sample_indices(gen: torch.Generator, valid: torch.Tensor, N: int,
                   n: int) -> torch.Tensor:
    """[N, n] indices: per hypothesis, n distinct indices among the True
    entries of `valid` (Gumbel top-k, ties to the lower index). With fewer
    than n valid entries the tail repeats invalid slots; the caller's
    weights guard that."""
    u = torch.rand((N,) + tuple(valid.shape), generator=gen,
                   device=valid.device).clamp_min(1e-20)
    g = -torch.log(-torch.log(u))
    scores = torch.where(valid, g, torch.full_like(g, float("-inf")))
    return top_k(scores, n)[1]


def ransac_essential(x1: torch.Tensor, x2: torch.Tensor, valid: torch.Tensor,
                     cfg: RansacConfig, gen: torch.Generator | None = None,
                     kernels: Kernels = KERNELS):
    """Robust essential-matrix estimation.

    x1, x2: [M, 2] normalized-coordinate correspondences; valid: [M] mask.
    Returns (E, inlier_mask [M], num_inliers). Deterministic for a given
    cfg.seed unless an explicit generator is passed."""
    if cfg.solver not in ("8pt", "5pt"):
        raise ValueError(f"unknown solver {cfg.solver!r}")
    if gen is None:
        gen = generator(cfg.seed, x1.device)
    N = cfg.num_hypotheses
    if cfg.solver == "5pt":
        idx = sample_indices(gen, valid, N, 5)
        cand, cmask = five_point(x1[idx], x2[idx], kernels)  # [N, 10, 3, 3]
        errs = sampson_error(cand.reshape(-1, 3, 3), x1, x2).view(
            N, MAX_CANDIDATES, -1)
        inls_c = (errs < cfg.inlier_threshold) & valid & cmask[..., None]
        b = torch.argmax(inls_c.sum(-1), dim=1)              # first maximum
        rows = torch.arange(N, device=x1.device)
        Es, inls = cand[rows, b], inls_c[rows, b]
    else:
        idx = sample_indices(gen, valid, N, cfg.sample_size)
        Es = eight_point(x1[idx], x2[idx], None, kernels)    # [N, 3, 3]
        inls = (sampson_error(Es, x1, x2) < cfg.inlier_threshold) & valid
    counts = inls.sum(-1)
    best = torch.argmax(counts).reshape(1)                   # first maximum
    E0 = Es.index_select(0, best)[0]
    inl0 = inls.index_select(0, best)[0]

    # polish: weighted 8-point refit on the winner's inliers, re-scored
    E1 = eight_point(x1, x2, inl0.to(x1.dtype), kernels)
    inl1 = (sampson_error(E1, x1, x2) < cfg.inlier_threshold) & valid
    use_refit = inl1.sum() >= inl0.sum()
    E = torch.where(use_refit, E1, E0)
    inl = torch.where(use_refit, inl1, inl0)
    return E, inl, inl.sum()


def estimate_relative_pose(x1: torch.Tensor, x2: torch.Tensor,
                           valid: torch.Tensor, cfg: RansacConfig,
                           gen: torch.Generator | None = None,
                           kernels: Kernels = KERNELS):
    """RANSAC essential + cheirality-checked pose + triangulation.

    Returns (R, t_unit, X [M, 3] in camera-1 frame, inlier_mask,
    n_inliers). Translation is up-to-scale (unit norm)."""
    E, inl, _ = ransac_essential(x1, x2, valid, cfg, gen, kernels)
    R, t, X, front = recover_pose(E, x1, x2, inl.to(x1.dtype), kernels)
    return R, t, X, inl & front, (inl & front).sum()

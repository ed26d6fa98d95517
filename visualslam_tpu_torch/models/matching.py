"""Descriptor matching: ratio test + mutual-best check
(visualslam_tpu/models/matching.py).

Batches over any leading axes: matching features [B, Ka, ...] against
[B, Kb, ...] matches B frame pairs at once. `cfg.impl` picks the path as
the JAX package does: "pallas" runs the streaming 2-NN kernel
(`kernels.l2_2nn`) when the metric is l2, both capacities are multiples of
`cfg.tile` and the descriptor width of 128; otherwise the dense distance
matrix, squared L2 or Hamming (`cfg.metric`; ORB's bit-packed
descriptors).

`match_features_jit(fa, fb, cfg, kernels)` is the JAX package's jitted
matcher: on the card one captured CUDA graph per shape key and (cfg,
kernels) (`utils.graphs.GraphProgram`, seedless); on the CPU, and for the
plain kernel set, the function itself.
"""

from __future__ import annotations

import torch

from visualslam_tpu_torch.models.types import Features, Matches
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.ops.distance import (
    hamming_distance_matrix,
    l2sq_distance_matrix,
)
from visualslam_tpu_torch.utils.config import MatchConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.masked import top_k_select

_BIG = 1e12
_MASKED = 1e3       # descriptor value of invalid rows on the 2-NN path


def distance_matrix(fa: Features, fb: Features,
                    metric: str) -> torch.Tensor:
    """Dense [..., Ka, Kb] distances: squared L2, or Hamming on ORB's
    bit-packed descriptors."""
    if metric == "l2":
        return l2sq_distance_matrix(fa.descriptors, fb.descriptors)
    if metric == "hamming":
        return hamming_distance_matrix(fa.descriptors, fb.descriptors)
    raise ValueError(f"unknown metric {metric!r}")


def _l2_2nn(kernels: Kernels, a: torch.Tensor, b: torch.Tensor):
    """kernels.l2_2nn over any leading axes: [..., Ka, D] x [..., Kb, D]."""
    lead = a.shape[:-2]
    best, second, nn = kernels.l2_2nn(a.reshape(-1, *a.shape[-2:]),
                                      b.reshape(-1, *b.shape[-2:]))
    return (best.reshape(*lead, -1), second.reshape(*lead, -1),
            nn.reshape(*lead, -1).long())


def match_features(fa: Features, fb: Features, cfg: MatchConfig,
                   kernels: Kernels = KERNELS) -> Matches:
    """Match two fixed-capacity Feature sets -> Matches[..., cfg.max_matches].

    Lowe ratio test (on squared distances for l2, hence ratio^2; on the
    Hamming distance itself for hamming), optional mutual-best check;
    matches ranked by distance, best first (ties to the lower index).
    `kernels`: ops.cuda.KERNELS (default) or ops.cuda.PLAIN, for the 2-NN
    path."""
    if cfg.metric not in ("l2", "hamming"):
        raise ValueError(f"unknown metric {cfg.metric!r}")
    va = fa.keypoints.valid
    vb = fb.keypoints.valid
    use_2nn = (cfg.impl == "pallas" and cfg.metric == "l2"
               and fa.capacity % cfg.tile == 0
               and fb.capacity % cfg.tile == 0
               and fa.descriptors.shape[-1] % 128 == 0)
    if use_2nn:
        # invalid rows get a large constant descriptor so their distances
        # can never win the streaming 2-NN reduction
        da = torch.where(va[..., None], fa.descriptors.float(), _MASKED)
        db = torch.where(vb[..., None], fb.descriptors.float(), _MASKED)
        best, second, nn = _l2_2nn(kernels, da, db)
        # distances involving a masked row are >= ~1e6 >> any real match
        best = torch.where(va & (best < 1e6), best, _BIG)
        ok = va & (best < _BIG) & (best < cfg.ratio ** 2 * second)
        if cfg.mutual:
            _, _, col_nn = _l2_2nn(kernels, db, da)
            rows = torch.arange(fa.capacity, device=va.device)
            ok &= col_nn.gather(-1, nn) == rows
    else:
        dist = distance_matrix(fa, fb, cfg.metric)
        big = torch.full_like(dist, _BIG)
        dist = torch.where(va[..., :, None] & vb[..., None, :], dist, big)
        best = dist.amin(dim=-1)
        nn = dist.argmin(dim=-1)                               # first minimum
        cols = torch.arange(dist.shape[-1], device=dist.device)
        second = torch.where(cols == nn[..., None], big, dist).amin(dim=-1)
        ratio = cfg.ratio ** 2 if cfg.metric == "l2" else cfg.ratio
        ok = va & (best < _BIG) & (best < ratio * second)
        if cfg.mutual:
            col_best = dist.argmin(dim=-2)                     # [..., Kb]
            rows = torch.arange(dist.shape[-2], device=dist.device)
            ok &= col_best.gather(-1, nn) == rows

    idx, mask = top_k_select(-best, ok, cfg.max_matches)
    zero = torch.zeros_like(idx)
    return Matches(
        idx_a=torch.where(mask, idx, zero).to(torch.int32),
        idx_b=torch.where(mask, nn.gather(-1, idx), zero).to(torch.int32),
        distance=torch.where(mask, best.gather(-1, idx),
                             torch.zeros((), device=best.device)),
        valid=mask,
    )


def match_body(x: tuple, cfg: tuple) -> Matches:
    """The matcher programs' function: x = (fa, fb), cfg = (MatchConfig,
    Kernels)."""
    fa, fb = x
    mcfg, kernels = cfg
    return match_features(fa, fb, mcfg, kernels)


_MATCH = GraphProgram(match_body, seeded=False)


def match_features_jit(fa: Features, fb: Features, cfg: MatchConfig,
                       kernels: Kernels = KERNELS) -> Matches:
    """match_features as one captured graph per shape key and (cfg,
    kernels); the matches are the caller's (copies of the graph's
    outputs)."""
    return _MATCH((fa, fb), (cfg, kernels))


match_features_jit.program = _MATCH

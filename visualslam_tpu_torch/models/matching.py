"""Descriptor matching: ratio test + mutual-best check
(visualslam_tpu/models/matching.py, the dense-distance path).

Batches over any leading axes: matching features [B, Ka, ...] against
[B, Kb, ...] matches B frame pairs at once.
"""

from __future__ import annotations

import torch

from visualslam_tpu_torch.models.types import Features, Matches
from visualslam_tpu_torch.ops.distance import l2sq_distance_matrix
from visualslam_tpu_torch.utils.config import MatchConfig
from visualslam_tpu_torch.utils.masked import top_k_select

_BIG = 1e12


def match_features(fa: Features, fb: Features, cfg: MatchConfig) -> Matches:
    """Match two fixed-capacity Feature sets -> Matches[..., cfg.max_matches].

    Lowe ratio test on squared distances (hence ratio^2), optional
    mutual-best check; matches ranked by distance, best first (ties to the
    lower index)."""
    if cfg.impl != "xla":
        raise NotImplementedError(
            f"MatchConfig.impl={cfg.impl!r} (the streaming 2-NN kernel) is "
            "not ported yet; see ROADMAP.md B.5")
    if cfg.metric != "l2":
        raise NotImplementedError(
            f"metric {cfg.metric!r} comes with the ORB frontend; see "
            "ROADMAP.md A.8")
    va = fa.keypoints.valid
    vb = fb.keypoints.valid
    dist = l2sq_distance_matrix(fa.descriptors, fb.descriptors)
    big = torch.full_like(dist, _BIG)
    dist = torch.where(va[..., :, None] & vb[..., None, :], dist, big)

    best = dist.amin(dim=-1)
    nn = dist.argmin(dim=-1)                                   # first minimum
    cols = torch.arange(dist.shape[-1], device=dist.device)
    second = torch.where(cols == nn[..., None], big, dist).amin(dim=-1)
    ok = va & (best < _BIG) & (best < cfg.ratio ** 2 * second)
    if cfg.mutual:
        col_best = dist.argmin(dim=-2)                         # [..., Kb]
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

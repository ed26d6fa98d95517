"""Fixed-capacity masked-set utilities (visualslam_tpu/utils/masked.py).

A set of at most K things is a struct-of-arrays with a boolean validity
mask: `top_k_select` / `block_top_k_select` pick the top K of a score map,
`compact` moves the valid entries to the front (stable), `merge` keeps the
K best of two masked sets, `masked_mean` averages the valid entries.

Both selectors work on the last axis and batch over any leading axes (one
row per frame). `jax.lax.top_k` puts the lower index first on ties and
`torch.topk` promises no order, so selection here is a stable descending
sort: equal scores keep the lower index first, and the port picks the same
entries as the JAX package even where scores tie.
"""

from __future__ import annotations

import torch

NEG_INF = float("-inf")


def top_k(scores: torch.Tensor, k: int):
    """(values, indices) of the k largest along the last axis, ties to the
    lower index (jax.lax.top_k order)."""
    vals, idx = torch.sort(scores, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _pad_to(top: torch.Tensor, idx: torch.Tensor, k: int):
    """Capacity exceeds population: pad with masked (-inf, index 0) slots."""
    kk = top.shape[-1]
    if kk == k:
        return top, idx
    pad = top.shape[:-1] + (k - kk,)
    top = torch.cat([top, top.new_full(pad, NEG_INF)], dim=-1)
    idx = torch.cat([idx, idx.new_zeros(pad)], dim=-1)
    return top, idx


def top_k_select(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Top-k entries of `scores` restricted to `valid`, along the last axis.

    Returns (indices [..., k] int64, mask [..., k] bool); mask marks the
    selections that were valid (a short population leaves a masked tail
    whose indices are in range but arbitrary)."""
    n = scores.shape[-1]
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    top, idx = _pad_to(*top_k(s, min(k, n)), k)
    return idx, top > NEG_INF


def block_top_k_select(scores: torch.Tensor, valid: torch.Tensor, k: int):
    """Two-stage top-k: each `block` consecutive scores reduce to their max
    (first index on ties), then exact top-k over the block winners. At most
    one candidate per block. The block is the largest power of two that
    keeps >= 16k blocks; below 8 the exact `top_k_select` runs. Returns
    (indices [..., k] int64, mask [..., k])."""
    n = scores.shape[-1]
    block = 1
    while block * 2 <= n // (16 * k):
        block *= 2
    if block < 8 or n <= 4 * block:
        return top_k_select(scores, valid, k)
    pad = (-n) % block
    s = torch.where(valid, scores, torch.full_like(scores, NEG_INF))
    if pad:
        s = torch.cat([s, s.new_full(s.shape[:-1] + (pad,), NEG_INF)], -1)
    sb = s.reshape(s.shape[:-1] + (s.shape[-1] // block, block))
    bmax = sb.amax(dim=-1)
    barg = sb.argmax(dim=-1)
    top, bidx = top_k(bmax, min(k, bmax.shape[-1]))
    top, idx = _pad_to(top, bidx * block + barg.gather(-1, bidx), k)
    return idx.clamp(max=n - 1), top > NEG_INF


def compact(mask: torch.Tensor, *arrays: torch.Tensor):
    """Stable-compact along the first axis: the valid entries first, in
    their order, then the invalid ones in theirs. Returns (new_mask,
    *reordered_arrays)."""
    order = torch.sort((~mask).to(torch.uint8), stable=True)[1]
    new_mask = torch.arange(mask.shape[0], device=mask.device) < mask.sum()
    return (new_mask,) + tuple(a[order] for a in arrays)


def merge(score_a, mask_a, score_b, mask_b, k: int, *array_pairs):
    """Merge two masked sets, keeping the k best by score (ties to the
    lower index of a ++ b). array_pairs is a flat sequence (a0, b0, a1,
    b1, ...) of matching arrays. Returns (scores [k], mask [k],
    *merged_arrays); the scores of masked slots are 0."""
    assert len(array_pairs) % 2 == 0
    scores = torch.cat([
        torch.where(mask_a, score_a, torch.full_like(score_a, NEG_INF)),
        torch.where(mask_b, score_b, torch.full_like(score_b, NEG_INF))])
    top, idx = top_k(scores, k)
    mask = top > NEG_INF
    merged = tuple(torch.cat([array_pairs[i], array_pairs[i + 1]])[idx]
                   for i in range(0, len(array_pairs), 2))
    return (torch.where(mask, top, torch.zeros_like(top)), mask) + merged


def masked_mean(x: torch.Tensor, mask: torch.Tensor, axis=None,
                eps: float = 1e-12) -> torch.Tensor:
    """Mean of x over the True entries of mask (eps keeps an empty mask
    at 0)."""
    m = mask.to(x.dtype)
    if axis is None:
        return (x * m).sum() / (m.sum() + eps)
    return (x * m).sum(dim=axis) / (m.sum(dim=axis) + eps)

"""Fixed-capacity masked-set selection (visualslam_tpu/utils/masked.py).

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

"""Collectives over an in-process mesh
(visualslam_tpu/parallel/collectives.py).

Every function takes one tensor per shard (a list, in shard order) and
returns one tensor per shard, each on its input's device. A hop is a copy
to the next shard's device. The three ring functions follow the JAX
package's ppermute schedule hop by hop, with the same `(idx - s - 1) % n`
chunk arithmetic, so each chunk gets the same float32 adds in the same
order: on the CPU they equal the JAX ring bit for bit. `psum`, `pmin`,
`pmax` and `all_gather` are the plain collectives: `psum` adds the shards
in index order (XLA's all-reduce picks its own order, so the two differ
in rounding only).

On a virtual mesh several shards share a device, and `Tensor.to` returns
the tensor itself when the destination is its own device. A received
tensor that is then updated in place would corrupt the sender's copy, so
every hop and every replicated result here is a fresh tensor (`_send`);
`_at` is for reads only.
"""

from __future__ import annotations

from typing import Sequence

import torch


def _send(x: torch.Tensor, device) -> torch.Tensor:
    """A fresh copy of x on `device` (never an alias, even on its own
    device)."""
    return torch.empty_like(x, device=device).copy_(x)


def _at(x: torch.Tensor, device) -> torch.Tensor:
    """x on `device`, for reading only (may be x itself)."""
    return x.to(device)


def _replicate(x: torch.Tensor, xs: Sequence[torch.Tensor]) -> list:
    """x on every shard's device, a fresh tensor each; shard 0 keeps x."""
    return [x if i == 0 else _send(x, xi.device) for i, xi in enumerate(xs)]


def _reduce(xs: Sequence[torch.Tensor], op) -> list:
    dev = xs[0].device
    acc = xs[0]
    for x in xs[1:]:
        acc = op(acc, _at(x, dev))
    if len(xs) == 1:
        acc = acc.clone()
    return _replicate(acc, xs)


def psum(xs: Sequence[torch.Tensor]) -> list:
    """Sum over the shards, in index order, replicated."""
    return _reduce(xs, torch.add)


def pmin(xs: Sequence[torch.Tensor]) -> list:
    return _reduce(xs, torch.minimum)


def pmax(xs: Sequence[torch.Tensor]) -> list:
    return _reduce(xs, torch.maximum)


def all_gather(xs: Sequence[torch.Tensor]) -> list:
    """[chunk...] per shard -> [N, chunk...] on every shard."""
    return [torch.stack([_at(x, xr.device) for x in xs]) for xr in xs]


def ring_reduce_scatter(xs: Sequence[torch.Tensor]) -> list:
    """Reduce-scatter (sum) via a ring of neighbour hops.

    xs[d]: [N, ...], every shard a full copy with partial values (leading
    axis = destination shard). Returns shard d's summed chunk x_sum[d] of
    shape [...], after N-1 hops each carrying one chunk: at step s shard d
    sends its partial sum of chunk (d - s - 1) % n, and the receiver d+1
    folds it into that same chunk, ((d+1) - s - 2) % n in its own index
    arithmetic."""
    n = len(xs)
    if n == 1:
        return [xs[0][0]]
    acc = [x.clone() for x in xs]
    for s in range(n - 1):
        recv = [_send(acc[d][(d - s - 1) % n], acc[(d + 1) % n].device)
                for d in range(n)]
        for d in range(n):
            r = (d + 1) % n
            acc[r][(r - s - 2) % n] += recv[d]
    return [acc[d][d] for d in range(n)]


def ring_all_gather(xs: Sequence[torch.Tensor]) -> list:
    """All-gather via a ring: [chunk...] per shard -> [N, chunk...] on
    every shard (chunk c from shard c), N-1 neighbour hops."""
    n = len(xs)
    out = [x.new_zeros((n,) + tuple(x.shape)) for x in xs]
    for d in range(n):
        out[d][d] = xs[d]
    cur = list(xs)
    for s in range(n - 1):
        cur = [_send(cur[(r - 1) % n], xs[r].device) for r in range(n)]
        for r in range(n):
            out[r][(r - s - 1) % n] = cur[r]
    return out


def ring_allreduce(xs: Sequence[torch.Tensor]) -> list:
    """All-reduce (sum): a reduce-scatter ring (N-1 hops, each carrying 1/N
    of the data) over the flattened, zero-padded tensors, then an
    all-gather of the reduced chunks."""
    n = len(xs)
    if n == 1:
        return [xs[0]]
    shape = xs[0].shape
    m = xs[0].numel()
    pad = (-m) % n
    acc = []
    for x in xs:
        flat = x.reshape(-1)
        flat = torch.cat([flat, flat.new_zeros(pad)]) if pad else flat.clone()
        acc.append(flat.reshape(n, -1))
    # at step s shard d sends its partial sum of chunk (d - s) % n; after
    # N-1 steps shard d holds the complete sum of chunk (d + 1) % n
    for s in range(n - 1):
        recv = [_send(acc[d][(d - s) % n], acc[(d + 1) % n].device)
                for d in range(n)]
        for d in range(n):
            r = (d + 1) % n
            acc[r][(r - s - 1) % n] += recv[d]
    gathered = all_gather([acc[d][(d + 1) % n] for d in range(n)])
    # chunk c came from shard (c - 1) % n (a roll: indexing by a host list
    # would copy the list to the card and sync)
    return [torch.roll(g, 1, 0).reshape(-1)[:m].reshape(shape)
            for g in gathered]

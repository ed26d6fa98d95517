"""Sharded descriptor matching (visualslam_tpu/parallel/dist_match.py): the
B side of a big matching problem is sharded over the mesh, every shard
computes a LOCAL 2-NN (best + second-best distance and best index) against
its shard with one float32 product, and a min tournament combines them:

    best     = min_s best_s
    second   = min_s second-smallest of {best_s, second_s} pooled
    argmin   = index of the shard achieving the global best

Communication: pmins / pmaxes / one psum of [Ka] vectors, independent of
Kb; the full [Ka, Kb] distance matrix never exists on any device. Ties go
to the lowest index within a shard (`utils/masked.top_k`, jax.lax.top_k's
order) and to the lowest shard across shards. On one card the whole of it
replays one captured graph (parallel/programs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from visualslam_tpu_torch.parallel import collectives as col
from visualslam_tpu_torch.parallel.mesh import Mesh, axis_devices
from visualslam_tpu_torch.parallel.programs import (
    MeshGraphProgram,
    MeshKey,
    mesh_input,
)
from visualslam_tpu_torch.utils.masked import top_k
from visualslam_tpu_torch.utils.precision import f32_matmul

_BIG = 1e30


def _local_2nn(qa: torch.Tensor, kb: torch.Tensor, vb: torch.Tensor):
    """2-NN of each query row against the local key shard.
    qa [Ka, D], kb [Kb_s, D], vb [Kb_s] validity. Returns
    (best [Ka], second [Ka], idx [Ka] local index)."""
    na = (qa * qa).sum(-1, keepdim=True)
    nb = (kb * kb).sum(-1, keepdim=True)
    d = torch.clamp_min(na + nb.T - 2.0 * (qa @ kb.T), 0.0)
    d = torch.where(vb[None, :], d, torch.full_like(d, _BIG))
    neg2, idx2 = top_k(-d, 2)
    return -neg2[:, 0], -neg2[:, 1], idx2[:, 0]


def _sharded_2nn(x: tuple, cfg: tuple) -> tuple:
    """The sharded 2-NN over the mesh: x = (qa, kb_sharded, vb_sharded),
    cfg = (MeshKey, None)."""
    qa, kb_sharded, vb_sharded = x
    devs = cfg[0].devices
    f32_matmul()
    n = len(devs)
    Kb_s = kb_sharded.shape[1]
    best, second, gidx = [], [], []
    for s, dev in enumerate(devs):
        b, sec, i = _local_2nn(qa.to(dev), kb_sharded[s].to(dev),
                               vb_sharded[s].to(dev))
        best.append(b)
        second.append(sec)
        gidx.append((s * Kb_s + i).to(torch.int32))

    gbest = col.pmin(best)
    # second-best overall = min over shards of (second_s, or best_s if that
    # shard doesn't hold the global best)
    cand = [torch.where(b == g, sec, b)
            for b, sec, g in zip(best, second, gbest)]
    gsecond = [torch.minimum(a, b)
               for a, b in zip(col.pmin(cand), col.pmin(second))]
    # winning shard's index: ties keep the lowest shard, so exactly one
    # shard contributes to the psum
    mine = [b == g for b, g in zip(best, gbest)]
    neg = [torch.where(m, torch.full_like(i, -(s + 1)),
                       torch.full_like(i, -(n + 2)))
           for s, (m, i) in enumerate(zip(mine, gidx))]
    min_winner = [-w for w in col.pmax(neg)]
    keep = [m & (w == s + 1)
            for s, (m, w) in enumerate(zip(mine, min_winner))]
    gidx_out = col.psum([torch.where(k, i, torch.zeros_like(i))
                         for k, i in zip(keep, gidx)])
    return gbest[0], gsecond[0], gidx_out[0]


_SHARDED_2NN = MeshGraphProgram(_sharded_2nn)


def sharded_2nn_args(qa: torch.Tensor, kb_sharded: torch.Tensor,
                     vb_sharded: torch.Tensor, mesh: Mesh,
                     axis: str = "shard") -> tuple:
    """sharded_2nn's program arguments (x, (MeshKey, None))."""
    devs = axis_devices(mesh, axis)
    return (mesh_input((qa, kb_sharded, vb_sharded), devs),
            (MeshKey(None, devs, axis), None))


def sharded_2nn(qa: torch.Tensor, kb_sharded: torch.Tensor,
                vb_sharded: torch.Tensor, mesh: Mesh, axis: str = "shard"):
    """Global 2-NN over a B side sharded as [n, Kb_s, D] (+ validity
    [n, Kb_s]). Returns (best [Ka], second [Ka], global_idx [Ka] int32) on
    the first shard's device, with global_idx = shard * Kb_s + local
    index.

    On a mesh whose shards are all one CUDA device the shards' products
    and the tournament replay one captured graph per shape key and
    (devices, axis) (parallel/programs.MeshGraphProgram; the JAX package's
    jitted shard_map); on the CPU and over several devices they run
    eagerly. The results are the caller's."""
    return _SHARDED_2NN(*sharded_2nn_args(qa, kb_sharded, vb_sharded, mesh,
                                          axis))


sharded_2nn.program = _SHARDED_2NN


def shard_descriptors(desc: np.ndarray, valid: np.ndarray, n: int,
                      device="cuda"):
    """Host-side: pad + reshape a [Kb, D] descriptor set to [n, Kb_s, D]
    (+ validity [n, Kb_s]) for sharded_2nn, as tensors on `device` (the
    card unless the caller asks for the CPU); sharded_2nn moves each shard
    to its mesh device."""
    Kb, D = desc.shape
    Kb_s = -(-Kb // n)
    pad = n * Kb_s - Kb
    desc_p = np.concatenate(
        [desc, np.zeros((pad, D), desc.dtype)]) if pad else desc
    valid_p = np.concatenate(
        [valid, np.zeros(pad, bool)]) if pad else valid
    return (torch.as_tensor(desc_p.reshape(n, Kb_s, D), device=device),
            torch.as_tensor(valid_p.reshape(n, Kb_s), device=device))

"""Scale-space extrema candidates + sub-pixel localization
(visualslam_tpu/ops/extrema.py, with the fused candidate semantics of
visualslam_tpu/ops/pallas/extrema.py `pallas_extrema_candidates`).

Batched over frames: dog stacks are [B, D, H, W]. Candidates are the
strict 26-neighbour extrema above half the contrast threshold, reduced to
one winner per (16-row tile, level, column) by the extrema kernel, then the
top `capacity` winners per frame (extrema_impl "fused"/"auto"), or the top
`capacity` of the full score map (extrema_impl "pallas": the score kernel;
"xla": plain torch). A quadratic fit on each candidate's 3x3x3 cube refines
it and applies the contrast and edge tests.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.ops.cuda.extrema import NONE, TILE_H, extrema_mask
from visualslam_tpu_torch.utils.config import SiftConfig
from visualslam_tpu_torch.utils.constants import device_constant
from visualslam_tpu_torch.utils.masked import block_top_k_select


class Localized(NamedTuple):
    """Localization of [..., K] candidates."""

    offset: torch.Tensor      # [..., K, 3] fitted offset (ds, dy, dx)
    contrast: torch.Tensor    # [..., K] interpolated DoG value (signed)
    edge_ok: torch.Tensor     # [..., K] passes the edge test
    converged: torch.Tensor   # [..., K] solvable and offset within bounds


def extrema_candidates(dog: torch.Tensor, threshold: float, capacity: int,
                       kernels: Kernels = KERNELS):
    """Fused scan + candidate selection of [B, D, H, W] DoG stacks.

    Returns (lvl, y, x, score, sel), each [B, capacity]: interior grid
    positions of the selected extrema, |dog| there, and the selection mask.
    At most one candidate per (TILE_H rows x 1 column x 1 level) region."""
    B, D, H, W = dog.shape
    smax, srow = kernels.extrema_winners(dog.contiguous(), threshold)
    Wp = smax.shape[-1]
    flat = smax.reshape(B, -1)                         # [B, n * (D-2) * Wp]
    idx, sel = block_top_k_select(flat, flat > NONE / 10, capacity)
    per_tile = (D - 2) * Wp
    rem = idx % per_tile
    lvl = rem // Wp + 1
    col = rem % Wp
    row = (idx // per_tile) * TILE_H + srow.reshape(B, -1).gather(1, idx)
    return (lvl.to(torch.int32), row.to(torch.int32), col.to(torch.int32),
            flat.gather(1, idx), sel)


_CUBE_OFFSETS = [(dl, dy, dx) for dl in (-1, 0, 1) for dy in (-1, 0, 1)
                 for dx in (-1, 0, 1)]


def _cube_offsets(H: int, W: int) -> np.ndarray:
    """The 27 flat offsets of a 3x3x3 cube in [D, H, W], int64."""
    return np.array([(dl * H + dy) * W + dx for dl, dy, dx in _CUBE_OFFSETS],
                    np.int64)


def gather_cubes(dog: torch.Tensor, lvl: torch.Tensor, y: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """[B, K, 3, 3, 3] neighbourhoods of dog [B, D, H, W] centred at
    interior (lvl, y, x) [B, K]."""
    B, D, H, W = dog.shape
    K = lvl.shape[1]
    base = (lvl.long() * H + y.long()) * W + x.long()             # [B, K]
    offs = device_constant(("cube_offsets", H, W), dog.device,
                           lambda: _cube_offsets(H, W))
    idx = (base[:, :, None] + offs).reshape(B, K * 27)
    return dog.reshape(B, -1).gather(1, idx).reshape(B, K, 3, 3, 3)


def localize(cubes: torch.Tensor, cfg: SiftConfig) -> Localized:
    """Quadratic fit on [..., 3, 3, 3] DoG cubes (axes scale, y, x): solve
    H z = -g for the offset, interpolated contrast D + g.z / 2, and the
    tr^2 / det < (r + 1)^2 / r edge test on the spatial Hessian."""
    c = cubes
    d0 = c[..., 1, 1, 1]
    gs = 0.5 * (c[..., 2, 1, 1] - c[..., 0, 1, 1])
    gy = 0.5 * (c[..., 1, 2, 1] - c[..., 1, 0, 1])
    gx = 0.5 * (c[..., 1, 1, 2] - c[..., 1, 1, 0])
    g = torch.stack([gs, gy, gx], dim=-1)                          # [..., 3]
    hss = c[..., 2, 1, 1] + c[..., 0, 1, 1] - 2 * d0
    hyy = c[..., 1, 2, 1] + c[..., 1, 0, 1] - 2 * d0
    hxx = c[..., 1, 1, 2] + c[..., 1, 1, 0] - 2 * d0
    hsy = 0.25 * (c[..., 2, 2, 1] - c[..., 2, 0, 1] - c[..., 0, 2, 1]
                  + c[..., 0, 0, 1])
    hsx = 0.25 * (c[..., 2, 1, 2] - c[..., 2, 1, 0] - c[..., 0, 1, 2]
                  + c[..., 0, 1, 0])
    hyx = 0.25 * (c[..., 1, 2, 2] - c[..., 1, 2, 0] - c[..., 1, 0, 2]
                  + c[..., 1, 0, 0])

    # closed-form 3x3 solve through the adjugate
    det = (hss * (hyy * hxx - hyx * hyx)
           - hsy * (hsy * hxx - hyx * hsx)
           + hsx * (hsy * hyx - hyy * hsx))
    solvable = det.abs() > 1e-12
    safe_det = torch.where(solvable, det, torch.ones_like(det))
    adj = torch.stack([
        torch.stack([hyy * hxx - hyx * hyx, hsx * hyx - hsy * hxx,
                     hsy * hyx - hsx * hyy], -1),
        torch.stack([hyx * hsx - hsy * hxx, hss * hxx - hsx * hsx,
                     hsy * hsx - hss * hyx], -1),
        torch.stack([hsy * hyx - hyy * hsx, hsx * hsy - hss * hyx,
                     hss * hyy - hsy * hsy], -1),
    ], dim=-2)                                                     # [..., 3, 3]
    z = -torch.einsum("...ij,...j->...i", adj, g) / safe_det[..., None]
    contrast = d0 + 0.5 * torch.einsum("...i,...i->...", g, z)

    tr = hxx + hyy
    det2 = hxx * hyy - hyx * hyx
    r = cfg.edge_r
    edge_ok = (det2 > 0) & (tr * tr * r < det2 * (r + 1.0) ** 2)
    converged = solvable & (z.abs() <= 1.5).all(dim=-1)
    return Localized(offset=z, contrast=contrast, edge_ok=edge_ok,
                     converged=converged)


def detect_extrema(dog: torch.Tensor, cfg: SiftConfig,
                   capacity: int | None = None, kernels: Kernels = KERNELS):
    """Per-octave candidate detection on [B, D, H, W] DoG stacks.

    `cfg.extrema_impl` picks the candidates as the JAX package does:
    "fused" (and "auto", on every device) the per-tile winners of the fused
    kernel; "pallas" the full score map of the score kernel, then top-k;
    "xla" the same map in plain torch (no kernel).

    Returns (lvl, y, x, offset [B, K, 3], score, valid), K = capacity
    (default cfg.max_keypoints_per_octave): integer grid positions, the
    offset clamped to +-0.5, |interpolated contrast| and the validity mask.
    """
    impl = cfg.extrema_impl
    if impl not in ("auto", "fused", "pallas", "xla"):
        raise ValueError(f"unknown extrema_impl {impl!r}")
    k = capacity if capacity is not None else cfg.max_keypoints_per_octave
    thr = cfg.contrast_threshold
    if impl in ("auto", "fused"):
        lvl, y, x, _, sel = extrema_candidates(dog, thr, k, kernels)
    else:
        B, D, H, W = dog.shape
        if impl == "pallas":
            score = kernels.extrema_score(dog.contiguous(), thr)
            mask = score > NONE / 10
        else:
            score = dog.abs()
            mask = extrema_mask(dog) & (score > 0.5 * thr)
        idx, sel = block_top_k_select(score.reshape(B, -1),
                                      mask.reshape(B, -1), k)
        rem = idx % (H * W)
        lvl = (idx // (H * W)).to(torch.int32)
        y = (rem // W).to(torch.int32)
        x = (rem % W).to(torch.int32)
    one = torch.ones_like(lvl)
    # masked-out slots point at a safe interior location
    lvl = torch.where(sel, lvl, one)
    y = torch.where(sel, y, one)
    x = torch.where(sel, x, one)
    loc = localize(gather_cubes(dog, lvl, y, x), cfg)
    valid = (sel & loc.converged & loc.edge_ok
             & (loc.contrast.abs() > cfg.contrast_threshold))
    return lvl, y, x, loc.offset.clamp(-0.5, 0.5), loc.contrast.abs(), valid

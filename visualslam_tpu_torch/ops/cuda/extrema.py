"""Fused extrema scan + per-tile winner reduce: the CUDA kernel's wrapper
and its plain PyTorch version.

Replaces visualslam_tpu/ops/pallas/extrema.py `pallas_extrema_candidates`
(the `_fused_kernel` pallas_call in `_winners_batched`). On the H100 the
scan is memory-bound: it reads the DoG stack once (about 150 MB for a
16-frame octave-0 batch) and does ~27 compares per position. The kernel
(csrc/extrema.cu) gives one thread to each (frame, 16-row tile, padded
column), keeps a 3-row x 5-level x 3-column window in registers while it
walks the tile, and writes each winner once, so it equals the plain version
bit for bit. Unlike the TPU kernel it needs no padded copy of the input and
no pre-sliced halo rows: it reads the halo rows itself.

`extrema_winners` launches the kernel for a CUDA tensor and runs the plain
version for a CPU tensor; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from visualslam_tpu_torch.ops.cuda import build

TILE_H = 16
LANES = 128         # winner columns are padded to a multiple of this
NONE = -1e30        # score of "no extremum"
LEVELS = 5          # DoG levels per octave the kernel is built for


def winner_shape(B: int, D: int, H: int, W: int):
    """Shape of the winner planes: [B, ceil(H / TILE_H), D - 2, Wp]."""
    return B, -(-H // TILE_H), D - 2, -(-W // LANES) * LANES


def extrema_winners_ref(dog: torch.Tensor, threshold: float):
    """Plain version (ops/pallas/extrema.py `_scored_tile` + the tile
    reduce of `_fused_kernel`). dog: [B, D, H, W] float32; `threshold` is
    the contrast threshold (the pre-filter is |dog| > threshold / 2).
    Returns (smax [B, n, D-2, Wp] float32, srow [B, n, D-2, Wp] int32)."""
    B, D, H, W = dog.shape
    _, n, _, Wp = winner_shape(B, D, H, W)
    Hp = n * TILE_H
    # zero padding to the tile grid plus one ring for the neighbour slices;
    # every position whose neighbours touch padding is masked below
    x = F.pad(dog, (1, Wp - W + 1, 1, Hp - H + 1))
    c = x[:, 1:D - 1, 1:Hp + 1, 1:Wp + 1]                 # [B, D-2, Hp, Wp]
    gt = torch.ones_like(c, dtype=torch.bool)
    lt = torch.ones_like(c, dtype=torch.bool)
    for dl in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dl == dy == dx == 0:
                    continue
                nb = x[:, 1 + dl:D - 1 + dl, 1 + dy:Hp + 1 + dy,
                       1 + dx:Wp + 1 + dx]
                gt &= c > nb
                lt &= c < nb
    score = c.abs()
    rows = torch.arange(Hp, device=dog.device)[:, None]
    cols = torch.arange(Wp, device=dog.device)[None, :]
    interior = (rows >= 1) & (rows <= H - 2) & (cols >= 1) & (cols <= W - 2)
    ok = (gt | lt) & (score > 0.5 * threshold) & interior
    val = torch.where(ok, score, torch.full_like(score, NONE))
    val = val.reshape(B, D - 2, n, TILE_H, Wp)
    vmax = val.amax(dim=3)
    r = torch.arange(TILE_H, device=dog.device).reshape(1, 1, 1, TILE_H, 1)
    # ties (and columns with no extremum) go to the largest row
    vrow = torch.where(val == vmax[:, :, :, None], r,
                       torch.full_like(r, -1)).amax(dim=3)
    return (vmax.permute(0, 2, 1, 3).contiguous(),
            vrow.permute(0, 2, 1, 3).to(torch.int32).contiguous())


def extrema_winners(dog: torch.Tensor, threshold: float):
    """Per-(tile, level, column) extrema winners of a DoG stack
    [B, 5, H, W] float32. Same contract as `extrema_winners_ref`."""
    if dog.device.type == "cpu":
        return extrema_winners_ref(dog, threshold)
    if dog.device.type != "cuda":
        raise ValueError(f"extrema_winners: unsupported device {dog.device}")
    if dog.dtype != torch.float32 or dog.ndim != 4 or dog.shape[1] != LEVELS:
        raise ValueError("extrema_winners: expects float32 [B, 5, H, W], got "
                         f"{dog.dtype} {tuple(dog.shape)}")
    if not dog.is_contiguous():
        raise ValueError("extrema_winners: dog must be contiguous")
    B, D, H, W = dog.shape
    shape = winner_shape(B, D, H, W)
    smax = torch.empty(shape, dtype=torch.float32, device=dog.device)
    srow = torch.empty(shape, dtype=torch.int32, device=dog.device)
    lib = _lib()
    with torch.cuda.device(dog.device):
        rc = lib.extrema_winners(
            build.ptr(dog), build.ptr(smax), build.ptr(srow), B, H, W,
            shape[1], shape[3], TILE_H, 0.5 * threshold,
            build.stream_handle(dog.device))
    build.check_launch(rc, "extrema_winners")
    extrema_winners.launches += 1
    return smax, srow


extrema_winners.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load_library("extrema")
    fn = lib.extrema_winners
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib

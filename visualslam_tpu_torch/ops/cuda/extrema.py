"""Scale-space extrema scans: the CUDA kernels' wrappers and their plain
PyTorch versions.

`extrema_winners`, the fused extrema scan + per-tile winner reduce,
replaces visualslam_tpu/ops/pallas/extrema.py `pallas_extrema_candidates`
(the `_fused_kernel` pallas_call in `_winners_batched`); `extrema_score`,
the full masked score map of `extrema_impl="pallas"`, replaces
`pallas_extrema_score` (`_score_kernel`). On the H100 both are
memory-bound: they read the DoG stack once (150 MB for a 16-frame octave-0
batch, 0.045 ms at 3.35 TB/s); the winners write 8% of that, the score map
as much again.

One kernel template serves both (csrc/extrema.cu): a block owns a strip of
128 columns and one 16-row tile of one frame, streams the tile's rows (one
halo row above and below) through a shared-memory ring with cp.async,
several rows in flight, and each thread slides its column's 3-row window
down the tile as per-level row extremes, so a position's 26 compares become
two compares against the NaN-propagating max and min of its neighbours.
Rows and columns outside the image are zero-filled, and every position
whose window touches them is masked: compares and `fabsf` only, so both
kernels equal their plain versions bit for bit.

Each wrapper launches its kernel for a CUDA tensor and runs the plain
version for a CPU tensor; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

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


def _check(name: str, dog: torch.Tensor, levels: tuple) -> None:
    lo, hi = levels
    if dog.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {dog.device}")
    if (dog.dtype != torch.float32 or dog.ndim != 4
            or not lo <= dog.shape[1] <= hi):
        want = f"D = {lo}" if lo == hi else f"{lo} <= D <= {hi}"
        raise ValueError(f"{name}: expects float32 [B, D, H, W] with {want}, "
                         f"got {dog.dtype} {tuple(dog.shape)}")
    if not dog.is_contiguous():
        raise ValueError(f"{name}: dog must be contiguous")


def extrema_winners(dog: torch.Tensor, threshold: float):
    """Per-(tile, level, column) extrema winners of a DoG stack
    [B, 5, H, W] float32. Same contract as `extrema_winners_ref`."""
    if dog.device.type == "cpu":
        return extrema_winners_ref(dog, threshold)
    _check("extrema_winners", dog, (LEVELS, LEVELS))
    B, D, H, W = dog.shape
    shape = winner_shape(B, D, H, W)
    smax = torch.empty(shape, dtype=torch.float32, device=dog.device)
    srow = torch.empty(shape, dtype=torch.int32, device=dog.device)
    with build.on_device(dog.device):
        rc = _lib().extrema_winners(
            dog.data_ptr(), smax.data_ptr(), srow.data_ptr(), B, H, W,
            shape[3], 0.5 * threshold,
            build.stream_handle(dog.device))
    build.check_launch(rc, "extrema_winners")
    extrema_winners.launches += 1
    return smax, srow


extrema_winners.launches = 0


def extrema_mask(dog: torch.Tensor) -> torch.Tensor:
    """Strict 26-neighbour extrema over the last three axes (level, y, x)
    of a DoG stack [..., D, H, W] (visualslam_tpu/ops/extrema.py
    `extrema_mask`): True only at interior positions strictly greater or
    strictly smaller than all 26 neighbours."""
    D, H, W = dog.shape[-3:]
    if D < 3 or H < 3 or W < 3:
        return torch.zeros_like(dog, dtype=torch.bool)
    c = dog[..., 1:-1, 1:-1, 1:-1]
    gt = torch.ones_like(c, dtype=torch.bool)
    lt = torch.ones_like(c, dtype=torch.bool)
    for dl in (-1, 0, 1):
        for dy in (-1, 0, 1):
            for dx in (-1, 0, 1):
                if dl == dy == dx == 0:
                    continue
                nb = dog[..., 1 + dl:D - 1 + dl, 1 + dy:H - 1 + dy,
                         1 + dx:W - 1 + dx]
                gt &= c > nb
                lt &= c < nb
    return F.pad(gt | lt, (1, 1, 1, 1, 1, 1))


def extrema_score_ref(dog: torch.Tensor, threshold: float) -> torch.Tensor:
    """Plain version (ops/pallas/extrema.py `_score_kernel`): dog
    [B, D, H, W] float32 -> [B, D, H, W] float32, |dog| at strict interior
    26-neighbour extrema with |dog| > threshold / 2, NONE elsewhere (levels
    0 and D-1 included)."""
    score = dog.abs()
    ok = extrema_mask(dog) & (score > 0.5 * threshold)
    return torch.where(ok, score, torch.full_like(score, NONE))


SCORE_LEVELS = (3, 8)   # D range the score kernel is built for


def extrema_score(dog: torch.Tensor, threshold: float) -> torch.Tensor:
    """Masked extrema score map of a DoG stack [B, D, H, W] float32,
    3 <= D <= 8. Same contract as `extrema_score_ref`."""
    if dog.device.type == "cpu":
        return extrema_score_ref(dog, threshold)
    _check("extrema_score", dog, SCORE_LEVELS)
    B, D, H, W = dog.shape
    out = torch.empty_like(dog)
    with build.on_device(dog.device):
        rc = _lib().extrema_score(dog.data_ptr(), out.data_ptr(), B, D, H, W,
                                  0.5 * threshold,
                                  build.stream_handle(dog.device))
    build.check_launch(rc, "extrema_score")
    extrema_score.launches += 1
    return out


extrema_score.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("extrema")
    fn = lib.extrema_winners
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.extrema_score
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib

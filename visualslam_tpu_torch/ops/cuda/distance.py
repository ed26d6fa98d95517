"""Streaming 2-NN under squared L2: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces visualslam_tpu/ops/pallas/distance.py `pallas_l2_2nn`. On the H100
the search is compute-bound on the SIMT f32 path (1.07 GFLOP at
2048 x 2048 x 128, 2 MB of input); the kernel (csrc/distance.cu) stages
64-row tiles of A and B through shared memory, keeps a 4x4 register
micro-tile of a.b per thread and a running (best, second, index) per A
row, and never writes the distance matrix. The B range is split over
several blocks when a call has too few A tiles to fill the card, and the
splits are merged in a fixed order: the result does not depend on the
split.

`l2_2nn` launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from visualslam_tpu_torch.ops.cuda import build
from visualslam_tpu_torch.ops.distance import l2sq_distance_matrix

TILE = 64           # A rows per block and B rows per tile in the kernel
BIG = 1e30          # second-best where B has a single row (Pallas init)


def l2_2nn_ref(a: torch.Tensor, b: torch.Tensor):
    """Plain version. a: [P, Ka, D], b: [P, Kb, D] float32 ->
    (best [P, Ka] f32, second [P, Ka] f32, idx [P, Ka] int32): the smallest
    squared distance, the second smallest (as a multiset: a tie repeats
    the best) and the first index of the smallest, over the B rows."""
    d = l2sq_distance_matrix(a, b)                      # TF32 off: f32 product
    best = d.amin(dim=-1)
    idx = d.argmin(dim=-1)                              # first minimum
    cols = torch.arange(d.shape[-1], device=d.device)
    second = torch.where(cols == idx[..., None], torch.full_like(d, BIG),
                         d).amin(dim=-1)
    return best, second, idx.to(torch.int32)


def _splits(P: int, Ka: int, Kb: int, device) -> tuple[int, int]:
    """(nsplit, tiles per split): split B so that about two blocks per SM
    are in flight."""
    n_tiles = -(-Kb // TILE)
    blocks = P * -(-Ka // TILE)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    nsplit = max(1, min(n_tiles, -(-2 * sms // blocks)))
    per = -(-n_tiles // nsplit)
    return -(-n_tiles // per), per


def l2_2nn(a: torch.Tensor, b: torch.Tensor):
    """Streaming 2-NN of every A row over the B rows, pair by pair:
    a [P, Ka, D], b [P, Kb, D] float32. Same contract as `l2_2nn_ref`."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return l2_2nn_ref(a, b)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"l2_2nn: unsupported devices {a.device}, {b.device}")
    if (a.dtype != torch.float32 or b.dtype != torch.float32 or a.ndim != 3
            or b.ndim != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[2] or b.shape[1] < 1):
        raise ValueError("l2_2nn: expects float32 [P, Ka, D] and [P, Kb, D] "
                         f"with Kb >= 1, got {a.dtype} {tuple(a.shape)} and "
                         f"{b.dtype} {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("l2_2nn: a and b must be contiguous")
    P, Ka, D = a.shape
    Kb = b.shape[1]
    nsplit, per = _splits(P, Ka, Kb, a.device)
    part_best = torch.empty((P, nsplit, Ka), dtype=torch.float32,
                            device=a.device)
    part_second = torch.empty_like(part_best)
    part_idx = torch.empty((P, nsplit, Ka), dtype=torch.int32, device=a.device)
    best = torch.empty((P, Ka), dtype=torch.float32, device=a.device)
    second = torch.empty_like(best)
    idx = torch.empty((P, Ka), dtype=torch.int32, device=a.device)
    lib = _lib()
    with torch.cuda.device(a.device):
        rc = lib.l2_2nn(build.ptr(a), build.ptr(b), build.ptr(part_best),
                        build.ptr(part_second), build.ptr(part_idx),
                        build.ptr(best), build.ptr(second), build.ptr(idx),
                        P, Ka, Kb, D, nsplit, per,
                        build.stream_handle(a.device))
    build.check_launch(rc, "l2_2nn")
    l2_2nn.launches += 1
    return best, second, idx


l2_2nn.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load_library("distance")
    fn = lib.l2_2nn
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib

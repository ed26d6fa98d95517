"""Streaming 2-NN under squared L2: the CUDA kernel's wrapper and its plain
PyTorch version.

Replaces visualslam_tpu/ops/pallas/distance.py `pallas_l2_2nn`. On the H100
the search is bound by its products (1.07 GFLOP at 2048 x 2048 x 128, 2 MB
of input). The kernel (csrc/distance.cu) runs them on the tensor cores in
3xTF32 (lo.hi + hi.lo + hi.hi, f32 accumulation) with wgmma: one warpgroup
per 64 A rows holds A's tf32 hi and lo fragments in registers, 32-row B
tiles are copied with cp.async and split once into the products' shared
memory layout, and each thread keeps a running (best, second, index) per A
row; the distance matrix never reaches memory. When a call has too few A
tiles to fill the card, the B range is split over several blocks and the
last block of each A tile merges the splits in the same launch (a per-tile
counter); the result does not depend on the split. One launch per call, one
output allocation (three views of it); the SM count, the blocks an SM
holds (the build's occupancy, asked of the kernel's library) and the
scratch are cached; a program captured in a CUDA graph brings its own
scratch (`owned_scratch`).

`l2_2nn` launches the kernel for CUDA tensors and runs the plain version
for CPU tensors; anything else raises.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools

import torch

from visualslam_tpu_torch.ops.cuda import build
from visualslam_tpu_torch.ops.distance import l2sq_distance_matrix

A_TILE = 64         # A rows per block in the kernel
B_TILE = 32         # B rows per tile
BIG = 1e30          # second-best where B has a single row (Pallas init)
MAX_D = 192         # the widest descriptor the kernel's shared memory holds


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


def plan_splits(P: int, Ka: int, Kb: int, sms: int,
                per_sm: int) -> tuple[int, int]:
    """(nsplit, B tiles per split) for a call on a card of `sms` SMs that
    each hold `per_sm` blocks at once: split the B range only while the
    blocks (P x A tiles x nsplit) fit on the card at once. Split s takes
    tiles [s * per, min((s + 1) * per, ceil(Kb / B_TILE))); no split is
    empty."""
    n_tiles = -(-Kb // B_TILE)
    blocks = max(1, P * -(-Ka // A_TILE))
    return _cover(n_tiles, max(1, min(n_tiles, per_sm * sms // blocks)))


def _cover(n_tiles: int, nsplit: int) -> tuple[int, int]:
    per = -(-n_tiles // nsplit)
    return -(-n_tiles // per), per


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def _blocks_per_sm(index: int, D: int, vec: bool) -> int:
    """Blocks of the kernel instance a call of width D runs (vec: 16-byte
    copies) that fit on one SM of device `index` at once, from the build's
    registers and shared memory."""
    n = ctypes.c_int(0)
    with build.on_device(torch.device("cuda", index)):
        rc = _lib().l2_2nn_blocks_per_sm(D, int(vec), ctypes.byref(n))
    build.check_launch(rc, "l2_2nn_blocks_per_sm")
    return max(1, n.value)


_scratch: dict = {}
_owned = None       # (store, may grow) inside `owned_scratch`


@contextlib.contextmanager
def owned_scratch(store: dict, grow: bool):
    """Inside the block, `l2_2nn` takes its scratch from `store` (one entry
    per device, owned by the caller) instead of the per-stream cache. A
    CUDA graph bakes in the scratch pointers its capture saw: a captured
    program sizes its own scratch in an eager warm-up (grow=True) and
    captures with grow=False, where a call that needs more raises, so
    nothing regrows a buffer a graph still reads. Calls in one block must
    not run concurrently (they share the counters)."""
    global _owned
    prev, _owned = _owned, (store, grow)
    try:
        yield store
    finally:
        _owned = prev


def _scratch_for(device: torch.device, stream: int, n_counters: int,
                 n_part: int) -> tuple:
    """(counters int32 [n_counters], partials f32 [n_part]): views of one
    scratch tensor per (device, stream), grown when a call needs more, so
    concurrent streams never share a counter; inside `owned_scratch`, the
    caller's one per device. The counters start at 0 and every launch
    leaves them at 0."""
    store, grow = (_scratch, True) if _owned is None else _owned
    key = (device, stream) if _owned is None else device
    s = store.get(key)
    if s is None or s[0].numel() < n_counters or s[1].numel() < n_part:
        if not grow:
            raise RuntimeError(
                "l2_2nn: a captured program's scratch is smaller than this "
                f"call needs ({n_counters} counters, {n_part} partials)")
        if s is not None:
            n_counters = max(n_counters, s[0].numel())
            n_part = max(n_part, s[1].numel())
        buf = torch.zeros(n_counters + n_part, dtype=torch.int32,
                          device=device)
        s = (buf[:n_counters], buf[n_counters:].view(torch.float32))
        store[key] = s
    return s


def _check(a: torch.Tensor, b: torch.Tensor) -> None:
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"l2_2nn: unsupported devices {a.device}, {b.device}")
    if (a.dtype != torch.float32 or b.dtype != torch.float32 or a.ndim != 3
            or b.ndim != 3 or a.shape[0] != b.shape[0]
            or a.shape[2] != b.shape[2] or b.shape[1] < 1
            or not 1 <= a.shape[2] <= MAX_D):
        raise ValueError("l2_2nn: expects float32 [P, Ka, D] and [P, Kb, D] "
                         f"with Kb >= 1 and D <= {MAX_D}, got {a.dtype} "
                         f"{tuple(a.shape)} and {b.dtype} {tuple(b.shape)}")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("l2_2nn: a and b must be contiguous")


def l2_2nn(a: torch.Tensor, b: torch.Tensor):
    """Streaming 2-NN of every A row over the B rows, pair by pair:
    a [P, Ka, D], b [P, Kb, D] float32. Same contract as `l2_2nn_ref`."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return l2_2nn_ref(a, b)
    _check(a, b)
    return _launch(a, b, split_plan(a, b)[0])


def split_plan(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int, int]:
    """(nsplit, B tiles per split, blocks per SM) with which `l2_2nn` runs
    on CUDA tensors a and b: the blocks per SM of the kernel instance the
    call runs, and `plan_splits` on this card."""
    P, Ka, D = a.shape
    index = a.device.index
    vec = D % 4 == 0 and (a.data_ptr() | b.data_ptr()) % 16 == 0
    per_sm = _blocks_per_sm(index, D, vec)
    return plan_splits(P, Ka, b.shape[1], _sm_count(index), per_sm) + (per_sm,)


def launch(a: torch.Tensor, b: torch.Tensor, nsplit: int):
    """`l2_2nn` on CUDA tensors with the B range split `nsplit` ways (at
    most one split per B tile; the splits come out equal but the last): the
    same contract and the same bits for every split."""
    _check(a, b)
    return _launch(a, b, nsplit)


def _launch(a: torch.Tensor, b: torch.Tensor, nsplit: int):
    P, Ka, D = a.shape
    Kb = b.shape[1]
    nsplit, per = _cover(-(-Kb // B_TILE), max(1, nsplit))
    dev = a.device
    out = torch.empty((3, P, Ka), dtype=torch.float32, device=dev)
    with build.on_device(dev):
        stream = build.stream_handle(dev)
        counters, part = _scratch_for(dev, stream, P * -(-Ka // A_TILE),
                                      3 * P * nsplit * Ka)
        rc = _lib().l2_2nn(a.data_ptr(), b.data_ptr(), out.data_ptr(),
                           part.data_ptr(), counters.data_ptr(), P, Ka, Kb,
                           D, nsplit, per, stream)
    build.check_launch(rc, "l2_2nn")
    l2_2nn.launches += 1
    best, second, idx = out.unbind(0)
    return best, second, idx.view(torch.int32)


l2_2nn.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("distance")
    fn = lib.l2_2nn
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    occ = lib.l2_2nn_blocks_per_sm
    occ.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    occ.restype = ctypes.c_int
    return lib

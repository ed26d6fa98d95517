"""Fixed-order segment sums: the CUDA kernel's wrapper, its plan and its
plain PyTorch version.

The sparse sums of bundle adjustment and the pose graph (the JAX package's
`jax.ops.segment_sum`; no Pallas kernel). `index_add_` on a CUDA tensor
adds with atomics, in an order that changes from run to run, so two solves
of one problem on the card parted in their last bits and, through the LM
accept tests, in their results. On the CPU `index_add_` adds each row to
its segment in ascending observation order, starting from 0, which is also
XLA's order: the CPU path and the JAX package agree bit for bit. The kernel
(csrc/segment.cu) adds in that same order, so the card does too.

A `SegmentPlan` is built once per index array, on the index's device, with
no host read: the stable argsort of the indices and each segment's range in
it (`searchsorted` of the sorted indices against 0..n). Callers build one
per problem and pass it to every sum over that index (BA's camera, landmark
and pair indices; the pose graph's edge ends).

Index contract, as `index_add_`'s: every index lies in [0, n). The CPU path
raises on another (index_add_'s own check); on the card the kernel stops on
a device-side assert, as `index_add_` there does.

`segment_sum` launches the kernel for CUDA tensors (float32 or float64) and
runs the plain version for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from visualslam_tpu_torch.ops.cuda import build


class SegmentPlan(NamedTuple):
    idx: torch.Tensor       # [O] the segment of each row (any int dtype)
    perm: torch.Tensor      # [O] int64, the stable argsort of idx
    offsets: torch.Tensor   # [n + 1] int64: segment s is perm[offsets[s]:
    #                         offsets[s + 1]], rows in ascending order
    n: int


def segment_plan(idx: torch.Tensor, n: int) -> SegmentPlan:
    """The plan of a 1-D index array over n segments, on idx's device (a
    sort and a searchsorted; no host read)."""
    if idx.ndim != 1:
        raise ValueError(f"segment_plan: expects 1-D indices, got "
                         f"{tuple(idx.shape)}")
    srt, perm = torch.sort(idx, stable=True)
    bounds = torch.arange(n + 1, dtype=srt.dtype, device=idx.device)
    return SegmentPlan(idx, perm, torch.searchsorted(srt, bounds), int(n))


def segment_sum_ref(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Plain version: the rows of x [O, ...] summed per segment ->
    [n, ...], each segment's rows added in ascending order from 0."""
    return x.new_zeros((plan.n,) + x.shape[1:]).index_add_(0, plan.idx, x)


def segment_sum(x: torch.Tensor, plan: SegmentPlan) -> torch.Tensor:
    """Sum the rows of x [O, ...] per segment of `plan` -> [n, ...]. Same
    contract as `segment_sum_ref`; x is made contiguous first."""
    if x.device.type == "cpu" and plan.perm.device.type == "cpu":
        return segment_sum_ref(x, plan)
    if x.device.type != "cuda" or any(
            t.device != x.device for t in (plan.perm, plan.offsets)):
        raise ValueError(f"segment_sum: unsupported devices {x.device}, "
                         f"{plan.perm.device}, {plan.offsets.device}")
    if x.dtype not in _FN or x.ndim < 1 or x.shape[0] != plan.perm.shape[0]:
        raise ValueError(f"segment_sum: expects float32 or float64 rows "
                         f"[{plan.perm.shape[0]}, ...], got {x.dtype} "
                         f"{tuple(x.shape)}")
    if plan.n == 0 and x.shape[0] > 0:
        raise ValueError("segment_sum: rows but no segment")
    out = torch.empty((plan.n,) + x.shape[1:], dtype=x.dtype,
                      device=x.device)
    if out.numel() == 0:
        return out
    x = x.contiguous()
    width = out.numel() // plan.n
    with build.on_device(x.device):
        rc = getattr(_lib(), _FN[x.dtype])(
            x.data_ptr(), plan.perm.data_ptr(), plan.offsets.data_ptr(),
            out.data_ptr(), x.shape[0], plan.n, width,
            build.stream_handle(x.device))
    build.check_launch(rc, "segment_sum")
    segment_sum.launches += 1
    return out


segment_sum.launches = 0
_FN = {torch.float32: "segment_sum_f32", torch.float64: "segment_sum_f64"}


def long_path(rows: int, n: int, width: int) -> bool:
    """Whether the kernel takes its long-segment path (one block per
    segment) at these sizes; the other is one thread per output."""
    return bool(_lib().segment_sum_long_path(rows, n, width))


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("segment")
    for name in _FN.values():
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * 4
                       + [ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    lib.segment_sum_long_path.argtypes = [ctypes.c_longlong, ctypes.c_int,
                                          ctypes.c_int]
    lib.segment_sum_long_path.restype = ctypes.c_int
    return lib

"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch counters.

Each kernel module holds a wrapper that launches the kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor, the plain
version itself, and a launch counter (`<wrapper>.launches`, a plain integer
that only a kernel launch increments). Nothing GPU-related happens at
import.

`KERNELS` is the set the frontend, the matcher, tracking,
triangulation and the two-view solvers (the small eigensolver and 3x3 SVD)
call by default. `PLAIN` is the same set of plain versions:
passing it runs the plain path on any device, which is how a run on the
card compares the kernel path with the plain path. `segment.segment_sum`,
the fixed-order sums of BA and the pose graph, is outside that set: it has
no switch, and a CUDA tensor always takes the kernel. The launch counts
cover all ten.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from visualslam_tpu_torch.ops.cuda import (
    blur,
    descriptor,
    distance,
    extrema,
    segment,
    small_linalg,
    triangulate,
)


class Kernels(NamedTuple):
    extrema_winners: Callable
    orient_hist: Callable
    descriptor: Callable
    blur_stack: Callable
    l2_2nn: Callable
    extrema_score: Callable
    triangulate_dlt: Callable
    sym_eigh: Callable
    svd3: Callable


KERNELS = Kernels(extrema.extrema_winners, descriptor.orient_hist,
                  descriptor.descriptor, blur.blur_stack, distance.l2_2nn,
                  extrema.extrema_score, triangulate.triangulate_dlt,
                  small_linalg.sym_eigh, small_linalg.svd3)
PLAIN = Kernels(extrema.extrema_winners_ref,
                descriptor.orient_hist_levels_ref,
                descriptor.descriptor_levels_ref, blur.blur_stack_ref,
                distance.l2_2nn_ref, extrema.extrema_score_ref,
                triangulate.triangulate_ref, small_linalg.sym_eigh_ref,
                small_linalg.svd3_ref)


COUNTED = dict(KERNELS._asdict(), segment_sum=segment.segment_sum)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in COUNTED.items()}


def reset_launch_counts() -> None:
    for fn in COUNTED.values():
        fn.launches = 0


def set_launch_counts(counts: dict) -> None:
    """Put the counters back to `counts` (a capture into a CUDA graph runs
    the wrappers but launches nothing)."""
    for name, n in counts.items():
        COUNTED[name].launches = n


def add_launch_counts(counts: dict) -> None:
    """Add `counts` to the counters: a replayed CUDA graph launches the
    kernels its capture recorded, without running the wrappers."""
    for name, n in counts.items():
        COUNTED[name].launches += n


def reads_host(kernels: Kernels) -> bool:
    """True when the set's solvers read the host on the card (the plain
    `torch.linalg` versions read cuSOLVER's status): a captured program
    that runs them stays eager instead."""
    return (kernels.triangulate_dlt is triangulate.triangulate_ref
            or kernels.sym_eigh is small_linalg.sym_eigh_ref
            or kernels.svd3 is small_linalg.svd3_ref)

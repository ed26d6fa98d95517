"""Hand-written CUDA kernels for Hopper (sm_90a) and their launch counters.

Each kernel module holds a wrapper that launches the kernel for a CUDA
tensor and runs its plain PyTorch version for a CPU tensor, the plain
version itself, and a launch counter (`<wrapper>.launches`, a plain integer
that only a kernel launch increments). Nothing GPU-related happens at
import.

`KERNELS` is the set the frontend, the matcher and tracking call by
default. `PLAIN` is the same set of plain versions: passing it runs the
plain path on any device, which is how a run on the card compares the
kernel path with the plain path.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

from visualslam_tpu_torch.ops.cuda import blur, descriptor, distance, extrema


class Kernels(NamedTuple):
    extrema_winners: Callable
    orient_hist: Callable
    descriptor: Callable
    blur_stack: Callable
    l2_2nn: Callable
    extrema_score: Callable


KERNELS = Kernels(extrema.extrema_winners, descriptor.orient_hist,
                  descriptor.descriptor, blur.blur_stack, distance.l2_2nn,
                  extrema.extrema_score)
PLAIN = Kernels(extrema.extrema_winners_ref,
                descriptor.orient_hist_levels_ref,
                descriptor.descriptor_levels_ref, blur.blur_stack_ref,
                distance.l2_2nn_ref, extrema.extrema_score_ref)


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in KERNELS._asdict().items()}


def reset_launch_counts() -> None:
    for fn in KERNELS:
        fn.launches = 0

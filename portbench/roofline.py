"""The least time the card could take for the SIFT kernels' work, counted
from the problem (the frames' shapes, the configuration and the keypoints
the frontend returned), not from how the kernels do it.

Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the 700 W power limit). A kernel's bound is the larger of its
bytes (each input read once, each output written once) over the memory
rate and its operations over the peak rate of the units that run them;
the three SIFT kernels are bound by their bytes. Where the work depends on
the data, the count is what the returned keypoints needed at least, so a
share of this bound cannot pass 100% unless the time leaves out work.
"""

from __future__ import annotations

import math

PEAK_BYTES_S = 3.35e12       # HBM3
PEAK_F32_S = 67e12           # float32 outside the tensor cores
F32 = 4

# the part of each kernel's name the profiler reports
SIFT_KERNELS = ("extrema_winners_kernel", "patch_hist_kernel")


def octave_shapes(h: int, w: int, num_octaves: int,
                  upsample: bool) -> list:
    """[(H_o, W_o)]: octave 0 at the input's size (twice it with the
    initial upsample), each next one every second pixel of the last."""
    if upsample:
        h, w = 2 * h, 2 * w
    out = []
    for _ in range(num_octaves):
        out.append((h, w))
        h, w = (h + 1) // 2, (w + 1) // 2
    return out


def sift_call_bytes(cfg: dict, batch: int, h: int, w: int,
                    kps_per_octave: list) -> float:
    """Bytes the three SIFT kernels need at least in one frontend call of
    `batch` frames of h x w, given the valid keypoints it returned in each
    octave (summed over the frames). cfg is the configuration's
    SlamConfig as a dict.

    - extrema: the octave's difference-of-Gaussians stack (scale_samples
      + 2 levels, float32) read once;
    - orientation histograms: one orientation_window^2 box of gradient
      magnitude and angle (float32) per candidate, at least one candidate
      per max_orientations keypoints, and its histogram written;
    - descriptors: one descriptor_window^2 box per keypoint, and its
      descriptor (float32) written.
    """
    pyr, sift = cfg["pyramid"], cfg["sift"]
    shapes = octave_shapes(h, w, pyr["num_octaves"], pyr["initial_upsample"])
    levels = pyr["scale_samples"] + 2
    desc_len = sift["descriptor_width"] ** 2 * sift["descriptor_bins"]
    total = 0.0
    for (ho, wo), n in zip(shapes, kps_per_octave):
        total += F32 * batch * levels * ho * wo
        cands = math.ceil(n / sift["max_orientations"])
        total += cands * (2 * F32 * sift["orientation_window"] ** 2
                          + F32 * sift["num_orientation_bins"])
        total += n * (2 * F32 * sift["descriptor_window"] ** 2
                      + F32 * desc_len)
    return total


def bound_s(nbytes: float, ops: float = 0.0,
            ops_s: float = PEAK_F32_S) -> float:
    """The least seconds: the larger of bytes over the memory rate and
    operations over `ops_s`."""
    return max(nbytes / PEAK_BYTES_S, ops / ops_s)

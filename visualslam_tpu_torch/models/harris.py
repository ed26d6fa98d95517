"""Harris corner detector (visualslam_tpu/models/harris.py), batched over
frames: 3x3-sigma Gaussian blur, central differences, the structure tensor
over a window, R = det - k tr^2, window peaks above a threshold, and a
block top-k into a fixed-capacity Keypoints set sorted by response.

`detect_harris_jit(img, cfg)` is the JAX package's jitted detector: on the
card one captured CUDA graph per shape key and cfg
(`utils.graphs.GraphProgram`, seedless); on the CPU the function run
eagerly."""

from __future__ import annotations

import torch

from visualslam_tpu_torch.models.types import Keypoints
from visualslam_tpu_torch.ops.blur import gaussian_blur
from visualslam_tpu_torch.ops.cuda import KERNELS
from visualslam_tpu_torch.ops.gradients import central_diff
from visualslam_tpu_torch.ops.harris import harris_response
from visualslam_tpu_torch.ops.nms import window_peaks
from visualslam_tpu_torch.utils.config import HarrisConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.masked import block_top_k_select


def detect_harris(img: torch.Tensor, cfg: HarrisConfig) -> Keypoints:
    """Harris corners of [B, H, W] float frames in [0, 1] -> Keypoints
    [B, cfg.max_keypoints, ...], best response first."""
    B, H, W = img.shape
    dx, dy = central_diff(gaussian_blur(img, cfg.blur_sigma))
    resp = harris_response(dx, dy, cfg.window, cfg.k)
    peaks = window_peaks(resp, cfg.nms_window, cfg.response_threshold)
    flat = resp.reshape(B, -1)
    idx, mask = block_top_k_select(flat, peaks.reshape(B, -1),
                                   cfg.max_keypoints)
    yx = torch.stack([idx // W, idx % W], dim=-1).float() * mask[..., None]
    zero = torch.zeros_like(idx, dtype=torch.int32)
    return Keypoints(
        yx=yx,
        yx_oct=yx,
        octave=zero,
        level=zero,
        sigma=mask.float(),
        orientation=torch.zeros_like(yx[..., 0]),
        response=torch.where(mask, flat.gather(1, idx),
                             torch.zeros((), device=img.device)),
        valid=mask,
    )


def _detect_harris(x: tuple, cfg: tuple) -> Keypoints:
    img, = x
    return detect_harris(img, cfg[0])


_HARRIS = GraphProgram(_detect_harris, seeded=False)


def detect_harris_jit(img: torch.Tensor, cfg: HarrisConfig) -> Keypoints:
    """detect_harris as one captured graph per shape key and cfg; the
    keypoints are the caller's (copies of the graph's outputs)."""
    return _HARRIS((img,), (cfg, KERNELS))


detect_harris_jit.program = _HARRIS

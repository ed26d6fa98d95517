"""Gaussian scale-space pyramid (visualslam_tpu/models/pyramid.py).

Batched over frames natively: every product is [B, levels, H_o, W_o].
Octave 0's base is the frame, or its 2x linear upsample under
`initial_upsample` (the DEFAULT profile). Per octave: all levels blurred
from the octave base at absolute sigma base_sigma * k^l (blur_mode
"matmul": banded products, ops/blur.py; "pallas": the separable-convolution
kernel, `kernels.blur_stack`; "conv": separable convolutions; "incremental":
chained convolutions), DoG as adjacent level differences, gradients of the
levels the SIFT path reads, and the next octave's base as the stride-2
downsample of level s.

`build_pyramid_jit(img, cfg, kernels)` is the JAX package's jitted
pyramid: on the card one captured CUDA graph per shape key and
(cfg, kernels) (`utils.graphs.GraphProgram`, seedless) over the process's
constants for cfg (`pyramid_constants`); on the CPU, and for the plain
kernel set, the function run eagerly.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch

from visualslam_tpu_torch.ops.blur import (
    BlurBands,
    blur_stack,
    blur_stack_matmul,
    incremental_blur_stack,
)
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.ops.gradients import gradients
from visualslam_tpu_torch.ops.resize import (
    ResizeWeights,
    downsample2x_nearest,
    upsample2x_linear,
)
from visualslam_tpu_torch.utils.config import PyramidConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram


class ScaleSpace(NamedTuple):
    """Per-octave stacks. Each field is a tuple (len = num_octaves) of
    tensors [B, levels, H_o, W_o]; dog stacks have levels - 1 levels and
    the gradient stacks levels 1..s ("interior") or all levels ("all")."""

    gauss: Tuple[torch.Tensor, ...]
    dog: Tuple[torch.Tensor, ...]
    grad_x: Tuple[torch.Tensor, ...]
    grad_y: Tuple[torch.Tensor, ...]
    grad_mag: Tuple[torch.Tensor, ...]
    grad_ori: Tuple[torch.Tensor, ...]

    @property
    def grad_level_offset(self) -> int:
        """Gauss level of grad stack index 0: 0 when grad_levels="all",
        1 when "interior"."""
        return 0 if self.grad_mag[0].shape[1] == self.gauss[0].shape[1] else 1


def level_sigmas(cfg: PyramidConfig) -> Tuple[float, ...]:
    """Within-octave absolute sigmas (octave-base pixel units)."""
    return tuple(cfg.base_sigma * cfg.k_factor ** l
                 for l in range(cfg.levels_per_octave))


def auto_num_octaves(h: int, w: int) -> int:
    """floor(log2(min(H, W))) - 4, at least 1."""
    return max(1, int(math.floor(math.log2(min(h, w)))) - 4)


def build_pyramid(img: torch.Tensor, cfg: PyramidConfig,
                  bands: BlurBands | None = None,
                  kernels: Kernels = KERNELS,
                  resize: ResizeWeights | None = None) -> ScaleSpace:
    """Scale space of [B, H, W] frames. `bands` and `resize` hold the
    blur's and the upsample's constants across calls
    (frontend.SiftFrontend owns both); without them they are built for this
    call. `kernels` supplies `blur_stack` for blur_mode="pallas"
    (ops.cuda.KERNELS or ops.cuda.PLAIN)."""
    if img.ndim != 3:
        raise ValueError(f"build_pyramid expects [B, H, W], got {tuple(img.shape)}")
    if cfg.blur_mode not in ("matmul", "pallas", "conv", "incremental"):
        raise ValueError(f"unknown blur_mode {cfg.blur_mode!r}")
    img = img.to(getattr(torch, cfg.dtype))
    sigmas = level_sigmas(cfg)
    if bands is None:
        bands = BlurBands(sigmas, cfg.truncate)
    elif bands.sigmas != tuple(float(s) for s in sigmas):
        raise ValueError("bands were built for another sigma set")
    s = cfg.scale_samples
    base = upsample2x_linear(img, resize) if cfg.initial_upsample else img
    gauss, dog, gx, gy, gm, go = [], [], [], [], [], []
    for _ in range(cfg.num_octaves):
        if cfg.blur_mode == "pallas":
            stack = kernels.blur_stack(base.contiguous(),
                                       bands.taps(base.device))
        elif cfg.blur_mode == "conv":
            stack = blur_stack(base, sigmas, cfg.truncate)
        elif cfg.blur_mode == "incremental":
            stack = incremental_blur_stack(base, sigmas, cfg.truncate)
        else:
            stack = blur_stack_matmul(base, bands)              # [B, L, H, W]
        gauss.append(stack)
        dog.append(stack[:, 1:] - stack[:, :-1])                # [B, L-1, H, W]
        grad_src = stack if cfg.grad_levels == "all" else stack[:, 1:1 + s]
        dx, dy, mag, ori = gradients(grad_src)
        gx.append(dx)
        gy.append(dy)
        gm.append(mag)
        go.append(ori)
        base = downsample2x_nearest(stack[:, s])                # next octave base
    return ScaleSpace(tuple(gauss), tuple(dog), tuple(gx), tuple(gy),
                      tuple(gm), tuple(go))


_CONSTANTS: dict = {}


def pyramid_constants(cfg: PyramidConfig, device: torch.device) -> tuple:
    """(BlurBands, ResizeWeights) for cfg on `device`, one pair per process
    (made on first use and kept: a captured graph holds pointers to their
    buffers)."""
    key = (cfg, torch.device(device))
    pair = _CONSTANTS.get(key)
    if pair is None:
        pair = _CONSTANTS[key] = (BlurBands(level_sigmas(cfg), cfg.truncate),
                                  ResizeWeights())
    return pair


def _build_pyramid(x: tuple, cfg: tuple) -> ScaleSpace:
    img, = x
    pcfg, kernels = cfg
    bands, resize = pyramid_constants(pcfg, img.device)
    return build_pyramid(img, pcfg, bands, kernels, resize)


_PYRAMID = GraphProgram(_build_pyramid, seeded=False)


def build_pyramid_jit(img: torch.Tensor, cfg: PyramidConfig,
                      kernels: Kernels = KERNELS) -> ScaleSpace:
    """build_pyramid as one captured graph per shape key and
    (cfg, kernels); the stacks are the caller's (copies of the graph's
    outputs)."""
    return _PYRAMID((img,), (cfg, kernels))


build_pyramid_jit.program = _PYRAMID

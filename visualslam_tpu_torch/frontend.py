"""Detection + description frontend (visualslam_tpu/frontend.py).

`detect_and_describe(imgs, cfg)` runs a batch of frames [B, H, W] (uint8 or
float in [0, 1]) through the frontend `cfg.frontend` names and returns
Features with a leading frame axis. Only the SIFT frontend is ported;
`SiftFrontend` is the same call as an nn.Module that owns the config and
the blur's band matrices (built once per octave shape, moved with the
module).
"""

from __future__ import annotations

import torch
from torch import nn

from visualslam_tpu_torch.models.pyramid import level_sigmas
from visualslam_tpu_torch.models.sift import detect_and_describe_sift
from visualslam_tpu_torch.models.types import Features
from visualslam_tpu_torch.ops.blur import BlurBands
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.config import FAST_CONFIG, SlamConfig
from visualslam_tpu_torch.utils.precision import f32_matmul


def detect_and_describe(imgs: torch.Tensor, cfg: SlamConfig,
                        bands: BlurBands | None = None,
                        kernels: Kernels = KERNELS) -> Features:
    """imgs: [B, H, W] uint8 or float in [0, 1] -> Features [B, K, ...].
    `kernels`: ops.cuda.KERNELS (default; kernels on CUDA tensors, plain
    versions on CPU tensors) or ops.cuda.PLAIN (plain versions everywhere).

    The JAX reference traces the frontend at float32 matmul precision, so
    this turns TF32 off for CUDA matmuls and cuDNN (process-wide settings:
    torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 become False)."""
    f32_matmul()
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() * (1.0 / 255.0)
    if cfg.frontend == "sift":
        return detect_and_describe_sift(imgs, cfg.pyramid, cfg.sift, bands,
                                        kernels)
    if cfg.frontend in ("orb", "harris"):
        raise NotImplementedError(
            f"the {cfg.frontend} frontend is not ported yet; see ROADMAP.md A.9")
    raise ValueError(f"unknown frontend {cfg.frontend!r}")


class SiftFrontend(nn.Module):
    """The SIFT frontend of one config; holds the blur band matrices."""

    def __init__(self, cfg: SlamConfig = FAST_CONFIG,
                 kernels: Kernels = KERNELS):
        super().__init__()
        if cfg.frontend != "sift":
            raise ValueError(f"SiftFrontend needs frontend='sift', got "
                             f"{cfg.frontend!r}")
        self.cfg = cfg
        self.kernels = kernels
        self.bands = BlurBands(level_sigmas(cfg.pyramid), cfg.pyramid.truncate)

    def forward(self, imgs: torch.Tensor) -> Features:
        return detect_and_describe(imgs, self.cfg, self.bands, self.kernels)

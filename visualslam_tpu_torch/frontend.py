"""Detection + description frontend (visualslam_tpu/frontend.py).

`detect_and_describe(imgs, cfg)` runs a batch of frames [B, H, W] (uint8 or
float in [0, 1]) through the frontend `cfg.frontend` names ("sift", "orb"
or "harris") and returns Features with a leading frame axis. Each frontend
is also an nn.Module that owns its config and its constants (built once
per shape, moved with the module): `SiftFrontend` (the blur's band
matrices and the 2x upsample's weights), `OrbFrontend` (the level
resizes' weights) and `HarrisFrontend`; `make_frontend(cfg)` builds the
one `cfg.frontend` names.

`detect_and_describe_jit(imgs, cfg, kernels)` is the JAX package's jitted
frontend (visualslam_tpu/frontend.py `detect_and_describe_jit`; batched, so
it also stands for the JAX tracker's vmapped `"frontend_batched"`): on the
card one captured CUDA graph per shape key and (cfg, kernels)
(`utils.graphs.GraphProgram`, seedless), which reads the constants of the
process's frontend module for that config (`frontend_module`); on the CPU,
and for the plain kernel set, the same function run eagerly. Every
constant the frontends build on the host is built once per device, so no
call after the first copies from host memory.
"""

from __future__ import annotations

import torch
from torch import nn

from visualslam_tpu_torch.models.harris import detect_harris
from visualslam_tpu_torch.models.orb import detect_and_describe_orb
from visualslam_tpu_torch.models.pyramid import level_sigmas
from visualslam_tpu_torch.models.sift import detect_and_describe_sift
from visualslam_tpu_torch.models.types import Features
from visualslam_tpu_torch.ops.blur import BlurBands
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.ops.patches import extract_patches
from visualslam_tpu_torch.ops.resize import ResizeWeights
from visualslam_tpu_torch.utils.config import FAST_CONFIG, SlamConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.precision import f32_matmul

HARRIS_PATCH = 16       # side of the raw patch a Harris descriptor holds


def detect_and_describe(imgs: torch.Tensor, cfg: SlamConfig,
                        bands: BlurBands | None = None,
                        kernels: Kernels = KERNELS,
                        resize: ResizeWeights | None = None) -> Features:
    """imgs: [B, H, W] uint8 or float in [0, 1] -> Features [B, K, ...].
    `kernels`: ops.cuda.KERNELS (default; kernels on CUDA tensors, plain
    versions on CPU tensors) or ops.cuda.PLAIN (plain versions everywhere).
    `bands` and `resize` hold constants across calls (the modules below own
    them).

    The JAX reference traces the frontend at float32 matmul precision, so
    this turns TF32 off for CUDA matmuls and cuDNN (process-wide settings:
    torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 become False)."""
    f32_matmul()
    if imgs.dtype == torch.uint8:
        imgs = imgs.float() * (1.0 / 255.0)
    if cfg.frontend == "sift":
        return detect_and_describe_sift(imgs, cfg.pyramid, cfg.sift, bands,
                                        kernels, resize)
    if cfg.frontend == "orb":
        return detect_and_describe_orb(imgs, cfg.orb, resize)
    if cfg.frontend == "harris":
        kps = detect_harris(imgs, cfg.harris)
        # Harris detects only: the raw 16x16 patches, L2-normalised, are
        # the descriptors, so that matching still runs end to end
        desc = extract_patches(imgs, kps.yx, HARRIS_PATCH).flatten(2)
        norm = torch.linalg.vector_norm(desc, dim=-1, keepdim=True)
        return Features(kps, desc / norm.clamp_min(1e-8))
    raise ValueError(f"unknown frontend {cfg.frontend!r}")


class _Frontend(nn.Module):
    """A frontend of one config: `forward(imgs)` is detect_and_describe."""

    name = ""

    def __init__(self, cfg: SlamConfig, kernels: Kernels = KERNELS):
        super().__init__()
        if cfg.frontend != self.name:
            raise ValueError(f"{type(self).__name__} needs frontend="
                             f"{self.name!r}, got {cfg.frontend!r}")
        self.cfg = cfg
        self.kernels = kernels
        self.bands = None
        self.resize = ResizeWeights()

    def forward(self, imgs: torch.Tensor) -> Features:
        return detect_and_describe(imgs, self.cfg, self.bands, self.kernels,
                                   self.resize)


class SiftFrontend(_Frontend):
    """The SIFT frontend; holds the blur band matrices and the upsample's
    weights."""

    name = "sift"

    def __init__(self, cfg: SlamConfig = FAST_CONFIG,
                 kernels: Kernels = KERNELS):
        super().__init__(cfg, kernels)
        self.bands = BlurBands(level_sigmas(cfg.pyramid), cfg.pyramid.truncate)


class OrbFrontend(_Frontend):
    """The ORB frontend; holds the level resizes' weights."""

    name = "orb"


class HarrisFrontend(_Frontend):
    """The Harris frontend (detection + raw-patch descriptors)."""

    name = "harris"


def make_frontend(cfg: SlamConfig, kernels: Kernels = KERNELS) -> nn.Module:
    """The frontend module `cfg.frontend` names."""
    for cls in (SiftFrontend, OrbFrontend, HarrisFrontend):
        if cls.name == cfg.frontend:
            return cls(cfg, kernels)
    raise ValueError(f"unknown frontend {cfg.frontend!r}")


_MODULES: dict = {}


def frontend_module(cfg: SlamConfig, kernels: Kernels,
                    device: torch.device) -> nn.Module:
    """The process's frontend module of (cfg, kernels) on `device`, made on
    first use and kept: the frontend programs read its constants, which a
    captured graph holds pointers to."""
    key = (cfg, kernels, torch.device(device))
    mod = _MODULES.get(key)
    if mod is None:
        mod = _MODULES[key] = make_frontend(cfg, kernels).to(device)
    return mod


def frontend_body(x: tuple, cfg: tuple) -> Features:
    """The frontend programs' function: x = (imgs [B, H, W],), cfg =
    (SlamConfig, Kernels); the frames through `frontend_module`."""
    imgs, = x
    scfg, kernels = cfg
    return frontend_module(scfg, kernels, imgs.device)(imgs)


_DETECT = GraphProgram(frontend_body, seeded=False)


def detect_and_describe_jit(imgs: torch.Tensor, cfg: SlamConfig,
                            kernels: Kernels = KERNELS) -> Features:
    """detect_and_describe as one captured graph per shape key and
    (cfg, kernels); the results are the caller's (copies of the graph's
    outputs)."""
    return _DETECT((imgs,), (cfg, kernels))


detect_and_describe_jit.program = _DETECT

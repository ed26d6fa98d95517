"""PyTorch + CUDA port of visualslam_tpu for NVIDIA Hopper (H100).

The JAX package `visualslam_tpu` is the reference; module names here mirror
it. Ported so far: the batched SIFT frontend and frame matching
(`frontend.detect_and_describe`, `frontend.SiftFrontend`,
`models.matching.match_features`), per-frame tracking and keyframe
triangulation (`slam.track_step`, `backend.pnp`, `geometry`), the numpy map
(`slam.map_state`) and the dense-Schur window BA (`backend.ba`). Five TPU
kernels are hand-written in CUDA for sm_90a (`ops/cuda/`, sources in
`csrc/`). The port imports torch and never jax.
"""

from visualslam_tpu_torch.frontend import SiftFrontend, detect_and_describe
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Keypoints, Matches
from visualslam_tpu_torch.utils.config import (
    DEFAULT_CONFIG,
    FAST_CONFIG,
    SlamConfig,
)

__all__ = ["DEFAULT_CONFIG", "FAST_CONFIG", "Features", "Keypoints",
           "Matches", "SiftFrontend", "SlamConfig", "detect_and_describe",
           "match_features"]

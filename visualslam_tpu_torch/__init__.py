"""PyTorch + CUDA port of visualslam_tpu for NVIDIA Hopper (H100).

The JAX package `visualslam_tpu` is the reference; module names here mirror
it. The whole SLAM stream is ported: the batched SIFT frontend under both
profiles (FAST and the DEFAULT reference profile with its 2x upsample),
the ORB and Harris frontends, matching (L2 and Hamming), tracking, the
engine batch program, the host tracker (`slam.tracker.Tracker`) with
two-view init (8- and 5-point RANSAC), loop closure and global BA, the
three BA solvers, checkpoint / resume, the I/O modules and the command
line (`python -m visualslam_tpu_torch.cli`). The six TPU kernels are
hand-written in CUDA for sm_90a (`ops/cuda/`, sources in `csrc/`). The
parallel paths (`parallel/`) run over an in-process mesh of torch devices:
landmark- and trajectory-sharded BA, sharded 2-NN, the data-parallel
frontend, the stage-overlapped pipeline and the multi-process bootstrap.
On the card the JAX package's jitted programs are captured CUDA graphs
(`utils/graphs.py`): the frontends, the engine, the solvers, the two-view
init, the host-path tracker and the loop closer's verification. The port
imports torch and never jax.
"""

from visualslam_tpu_torch.frontend import (
    HarrisFrontend,
    OrbFrontend,
    SiftFrontend,
    detect_and_describe,
    detect_and_describe_jit,
    make_frontend,
)
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.types import Features, Keypoints, Matches
from visualslam_tpu_torch.utils.config import (
    DEFAULT_CONFIG,
    FAST_CONFIG,
    BAConfig,
    HarrisConfig,
    MatchConfig,
    OrbConfig,
    PyramidConfig,
    RansacConfig,
    SiftConfig,
    SlamConfig,
)

__all__ = ["BAConfig", "DEFAULT_CONFIG", "FAST_CONFIG", "Features",
           "HarrisConfig", "HarrisFrontend", "Keypoints", "MatchConfig",
           "Matches", "OrbConfig", "OrbFrontend", "PyramidConfig",
           "RansacConfig", "SiftConfig", "SiftFrontend", "SlamConfig",
           "detect_and_describe", "detect_and_describe_jit",
           "make_frontend", "match_features"]

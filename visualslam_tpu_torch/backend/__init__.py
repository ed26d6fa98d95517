"""Bundle adjustment (visualslam_tpu/backend/__init__.py's names)."""

from visualslam_tpu_torch.backend.ba import BAProblem, BAResult, run_ba, run_ba_jit  # noqa: F401

"""Two-view initialization's entry points (visualslam_tpu/slam/__init__.py's
names); the tracker, the engine and the loop closer are in their modules."""

from visualslam_tpu_torch.slam.two_view import (  # noqa: F401
    TwoViewResult,
    two_view_from_features,
    two_view_reconstruction,
    two_view_reconstruction_jit,
)

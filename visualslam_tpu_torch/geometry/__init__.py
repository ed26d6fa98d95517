"""Camera model, epipolar geometry, RANSAC and SE(3)
(visualslam_tpu/geometry/__init__.py's names)."""

from visualslam_tpu_torch.geometry.camera import normalized, project, unproject  # noqa: F401
from visualslam_tpu_torch.geometry.epipolar import (  # noqa: F401
    decompose_essential,
    eight_point,
    recover_pose,
    sampson_error,
    triangulate,
)
from visualslam_tpu_torch.geometry.ransac import estimate_relative_pose, ransac_essential  # noqa: F401
from visualslam_tpu_torch.geometry import se3  # noqa: F401

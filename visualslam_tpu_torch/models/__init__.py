"""Frontend models: the pyramid, the SIFT, ORB and Harris detectors and
descriptors, and matching (visualslam_tpu/models/__init__.py's names).
"""

from visualslam_tpu_torch.models.types import Features, Keypoints, Matches  # noqa: F401
from visualslam_tpu_torch.models.pyramid import ScaleSpace, build_pyramid, build_pyramid_jit  # noqa: F401
from visualslam_tpu_torch.models.harris import detect_harris, detect_harris_jit  # noqa: F401
from visualslam_tpu_torch.models.sift import (  # noqa: F401
    detect_and_describe_sift,
    detect_and_describe_sift_jit,
)
from visualslam_tpu_torch.models.orb import (  # noqa: F401
    detect_and_describe_orb,
    detect_and_describe_orb_jit,
)
from visualslam_tpu_torch.models.matching import match_features, match_features_jit  # noqa: F401

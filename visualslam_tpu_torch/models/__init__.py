"""Frontend models: the pyramid, the SIFT, ORB and Harris detectors and
descriptors, and matching (visualslam_tpu/models/__init__.py's names; the
frontend's and the matcher's `*_jit` programs are queued, ROADMAP A.2-A.3).
"""

from visualslam_tpu_torch.models.types import Features, Keypoints, Matches  # noqa: F401
from visualslam_tpu_torch.models.pyramid import ScaleSpace, build_pyramid  # noqa: F401
from visualslam_tpu_torch.models.harris import detect_harris  # noqa: F401
from visualslam_tpu_torch.models.sift import detect_and_describe_sift  # noqa: F401
from visualslam_tpu_torch.models.orb import detect_and_describe_orb  # noqa: F401
from visualslam_tpu_torch.models.matching import match_features  # noqa: F401

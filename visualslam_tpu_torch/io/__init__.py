"""Datasets and serialization (visualslam_tpu/io/__init__.py's names)."""

from visualslam_tpu_torch.io.kitti import (  # noqa: F401
    KittiOdometrySequence,
    SequenceInfo,
    SyntheticSequence,
)
from visualslam_tpu_torch.io.serialization import (  # noqa: F401
    load_descriptors_dat,
    load_kitti_poses,
    save_descriptors_dat,
    save_kitti_poses,
)

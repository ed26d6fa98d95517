"""Binary serialization: reference-compatible descriptor files + KITTI
trajectory IO (a numpy copy of visualslam_tpu/io/serialization.py).

The reference's only persistence is `featureDescriptors.dat`
(Diff_of_Gauss.cpp:838-863): header of three int32s {count, 128, frontSize}
followed by count x 128 raw float32 rows. Quirk: the reference writes
frontSize = sizeof(std::vector<float>) = 24 on x86-64 (it meant the element
size, 4); the reader here accepts either value, the writer emits 4. The
reference ships no reader at all (SURVEY.md §5 checkpoint) — this module
adds one.
"""

from __future__ import annotations

import struct

import numpy as np


def save_descriptors_dat(path: str, descriptors: np.ndarray) -> None:
    """Write the reference .dat format: int32 header {N, D, 4} + float32
    rows (Diff_of_Gauss.cpp:845-848, 860-863)."""
    desc = np.ascontiguousarray(descriptors, np.float32)
    n, d = desc.shape
    with open(path, "wb") as f:
        f.write(struct.pack("<iii", n, d, 4))
        f.write(desc.tobytes())


def load_descriptors_dat(path: str) -> np.ndarray:
    """Read the reference .dat format (accepts the reference's frontSize=24
    quirk as well as the corrected 4)."""
    with open(path, "rb") as f:
        n, d, front = struct.unpack("<iii", f.read(12))
        if front not in (4, 24):
            raise ValueError(f"unexpected frontSize {front} in {path}")
        data = np.frombuffer(f.read(n * d * 4), np.float32)
    return data.reshape(n, d).copy()


def save_kitti_poses(path: str, poses: np.ndarray) -> None:
    """KITTI odometry pose format: one row per frame, 12 floats (3x4
    camera-to-world matrix, row-major)."""
    poses = np.asarray(poses)
    assert poses.ndim == 3 and poses.shape[1:] == (3, 4), poses.shape
    np.savetxt(path, poses.reshape(len(poses), 12), fmt="%.9e")


def load_kitti_poses(path: str) -> np.ndarray:
    data = np.loadtxt(path).reshape(-1, 3, 4)
    return data.astype(np.float64)

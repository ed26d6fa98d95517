"""KITTI-odometry-style dataset IO (visualslam_tpu/io/kitti.py, numpy only).

Layout expected (standard KITTI odometry):
    root/sequences/<seq>/image_0/*.png   grayscale frames
    root/sequences/<seq>/calib.txt       P0..P3 projection matrices
    root/sequences/<seq>/times.txt       per-frame timestamps
    root/poses/<seq>.txt                 ground-truth 3x4 poses (optional)

`SequenceInfo` and the synthetic sequence with the same interface live in
io/synthetic.py and are re-exported here, under the reference's names.
Frames decode host-side: the native library (io/native.py) when it is
built, else PIL.
"""

from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from visualslam_tpu_torch.io.serialization import load_kitti_poses
from visualslam_tpu_torch.io.synthetic import (  # noqa: F401
    SequenceInfo,
    SyntheticSequence,
)


class KittiOdometrySequence:
    """Lazy frame loader for one KITTI odometry sequence."""

    def __init__(self, root: str, seq: str, camera: int = 0):
        self.root = root
        self.seq = seq
        self.dir = os.path.join(root, "sequences", seq)
        self.img_dir = os.path.join(self.dir, f"image_{camera}")
        self.files = sorted(
            f for f in os.listdir(self.img_dir) if f.endswith(".png"))
        P = self._read_calib()[camera]
        self.intrinsics = np.array([P[0, 0], P[1, 1], P[0, 2], P[1, 2]],
                                   np.float32)
        pose_file = os.path.join(root, "poses", f"{seq}.txt")
        self.gt_poses = (load_kitti_poses(pose_file)
                         if os.path.exists(pose_file) else None)
        times_file = os.path.join(self.dir, "times.txt")
        self.times = (np.loadtxt(times_file)
                      if os.path.exists(times_file) else None)
        first = self.frame(0)
        self.image_size = first.shape

    def _read_calib(self) -> dict[int, np.ndarray]:
        out = {}
        with open(os.path.join(self.dir, "calib.txt")) as f:
            for line in f:
                if not line.strip():
                    continue
                key, vals = line.split(":", 1)
                if key.startswith("P"):
                    out[int(key[1:])] = np.array(
                        vals.split(), np.float64).reshape(3, 4)
        return out

    def __len__(self) -> int:
        return len(self.files)

    def frame(self, i: int) -> np.ndarray:
        path = os.path.join(self.img_dir, self.files[i])
        from visualslam_tpu_torch.io import native

        if native.available():
            return native.decode_gray(path)
        from PIL import Image

        img = Image.open(path).convert("L")
        return np.asarray(img, np.float32) / 255.0

    def frames(self) -> Iterator[np.ndarray]:
        """Iterate frames; the native multithreaded prefetcher decodes ahead
        of the SLAM loop when the native library is built."""
        from visualslam_tpu_torch.io import native

        if native.available():
            paths = [os.path.join(self.img_dir, f) for f in self.files]
            pf = native.Prefetcher(paths, capacity=8, n_threads=4)
            try:
                yield from pf
            finally:
                pf.close()
            return
        for i in range(len(self)):
            yield self.frame(i)

    def info(self) -> SequenceInfo:
        return SequenceInfo(self.seq, len(self), self.intrinsics,
                            self.image_size, self.gt_poses, self.times)

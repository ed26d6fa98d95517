"""Fixed-capacity feature types (visualslam_tpu/models/types.py).

Struct-of-arrays NamedTuples of tensors with a validity mask. Every field
may carry a leading frame axis: a batched frontend returns fields shaped
[B, K, ...], one frame's fields are [K, ...]. Coordinates are (y, x) in
base-image pixels (`yx`) and within the (octave, level) image (`yx_oct`).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class Keypoints(NamedTuple):
    """[..., K] keypoints. Invalid slots have valid=False and zeroed fields."""

    yx: torch.Tensor            # [..., K, 2] float32 base-image (y, x)
    yx_oct: torch.Tensor        # [..., K, 2] float32 octave-image (y, x)
    octave: torch.Tensor        # [..., K] int32
    level: torch.Tensor         # [..., K] int32 DoG level
    sigma: torch.Tensor         # [..., K] float32 scale in base-image units
    orientation: torch.Tensor   # [..., K] float32 degrees [0, 360)
    response: torch.Tensor      # [..., K] float32 |DoG| contrast
    valid: torch.Tensor         # [..., K] bool

    @property
    def capacity(self) -> int:
        return self.valid.shape[-1]

    def count(self) -> torch.Tensor:
        """Valid keypoints per frame ([...] int64)."""
        return self.valid.sum(dim=-1)

    @staticmethod
    def empty(k: int, device=None) -> "Keypoints":
        """k invalid, zeroed slots."""
        f = torch.zeros(k, device=device)
        i = torch.zeros(k, dtype=torch.int32, device=device)
        return Keypoints(yx=torch.zeros(k, 2, device=device),
                         yx_oct=torch.zeros(k, 2, device=device),
                         octave=i, level=i, sigma=f, orientation=f,
                         response=f,
                         valid=torch.zeros(k, dtype=torch.bool, device=device))


class Features(NamedTuple):
    """Keypoints plus their descriptors ([..., K, D] float32)."""

    keypoints: Keypoints
    descriptors: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.keypoints.capacity


class Matches(NamedTuple):
    """Fixed-capacity match set between two Feature sets."""

    idx_a: torch.Tensor         # [..., M] int32 index into features_a
    idx_b: torch.Tensor         # [..., M] int32 index into features_b
    distance: torch.Tensor      # [..., M] float32 squared L2
    valid: torch.Tensor         # [..., M] bool

    def count(self) -> torch.Tensor:
        return self.valid.sum(dim=-1)

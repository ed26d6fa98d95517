"""Frozen configuration tree for the whole engine.

A copy of visualslam_tpu/utils/config.py: the JAX package imports jax at
package import, so the port cannot import even its numpy-only modules. The
tree, its defaults and its JSON form are the same, so
`SlamConfig.from_json(jax_cfg.to_json())` rebuilds a JAX config here
(tests/test_torch_pyramid.py holds the two equal). One difference:
`SiftConfig.hist_compute_dtype` returns a torch dtype.

Option values the port does not implement yet (the Tracker's `mesh`,
ROADMAP.md A.10) are rejected by the module that would run them
(NotImplementedError).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from typing import Any


def _asdict(cfg) -> dict:
    return dataclasses.asdict(cfg)


class _Base:
    """Shared helpers: serialization + functional update."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(_asdict(self), indent=2, sort_keys=True)

    @classmethod
    def from_dict(cls, d: dict):
        names = {f.name: f for f in dataclasses.fields(cls)}
        kw: dict[str, Any] = {}
        for k, v in d.items():
            if k not in names:
                raise KeyError(f"{cls.__name__}: unknown config key {k!r}")
            f = names[k]
            # under `from __future__ import annotations` f.type is a string;
            # resolve nested config classes from this module's globals
            sub = f.type if isinstance(f.type, type) else globals().get(
                str(f.type), None)
            if isinstance(v, dict) and sub is not None and dataclasses.is_dataclass(sub):
                v = sub.from_dict(v)
            elif isinstance(v, list):
                v = tuple(v)
            kw[k] = v
        return cls(**kw)


@dataclass(frozen=True)
class PyramidConfig(_Base):
    """SIFT scale-space pyramid.

    sigma(o, l) = 2^o * base_sigma * k^l with k = 2^(1/scale_samples),
    every level blurred from the octave base at its absolute sigma.
    """

    num_octaves: int = 4
    scale_samples: int = 3              # s; levels = s + 3
    base_sigma: float = 1.6
    initial_upsample: bool = True       # 2x linear before octave 0
    assumed_blur: float = 0.0           # blur already present in the input image
    truncate: float = 4.0               # Gaussian kernel radius = ceil(truncate*sigma)
    dtype: str = "float32"
    grad_levels: str = "interior"       # "interior": gradients of levels 1..s
    #                                     only (all the SIFT path reads);
    #                                     "all": every level
    blur_mode: str = "matmul"           # "matmul": banded-Toeplitz products;
    #                                     "pallas": the separable blur kernel;
    #                                     "conv": separable convolutions;
    #                                     "incremental": chained convolutions

    @property
    def levels_per_octave(self) -> int:
        return self.scale_samples + 3

    @property
    def k_factor(self) -> float:
        return 2.0 ** (1.0 / self.scale_samples)

    def sigma_at(self, octave: int, level: int) -> float:
        """Absolute sigma of (octave, level) in octave-base pixel units."""
        return self.base_sigma * (self.k_factor ** level)

    def abs_sigma(self, octave: int, level: int) -> float:
        """Sigma in base-image units: 2^o * base_sigma * k^l."""
        return (2.0 ** octave) * self.base_sigma * (self.k_factor ** level)


@dataclass(frozen=True)
class HarrisConfig(_Base):
    """Harris corner detector."""

    k: float = 0.04
    window: int = 3
    nms_window: int = 5
    blur_ksize: int = 3
    blur_sigma: float = 0.8
    response_threshold: float = 0.0
    max_keypoints: int = 1024


@dataclass(frozen=True)
class SiftConfig(_Base):
    """DoG detection + SIFT description."""

    contrast_threshold: float = 0.03    # interpolated |D| > threshold
    edge_r: float = 10.0                # tr^2/det < (r+1)^2/r
    max_keypoints_per_octave: int = 512
    max_keypoints: int = 1024           # total capacity after the merge
    num_orientation_bins: int = 36
    orientation_window: int = 16
    orientation_sigma_scale: float = 1.5
    orientation_peak_ratio: float = 0.8
    max_orientations: int = 2
    descriptor_width: int = 4           # 4x4 subregions
    descriptor_bins: int = 8            # 8 bins -> 128-D
    descriptor_window: int = 16
    descriptor_clamp: float = 0.2
    descriptor_norm: str = "l2"         # "l2" | "max"
    localization_offset_max: float = 0.5
    localize_iters: int = 1
    dense_extrema: bool = True
    extrema_impl: str = "auto"          # "auto" | "fused": the fused
    #                                     scan + per-tile winner reduce;
    #                                     "pallas": the full score map
    #                                     kernel, then top-k; "xla": the
    #                                     same map in plain torch
    patch_impl: str = "auto"            # "auto" | "pallas": the fused
    #                                     per-keypoint sampling + histogram
    #                                     kernels; "xla": the plain tent
    #                                     sampling + soft histogram
    hist_compute: str = "f32"           # "f32" | "bf16": bf16 (mag, ori)
    #                                     patches of 32 rows into the
    #                                     kernels, accumulation in f32
    octave_capacity_decay: bool = False  # halve candidate capacity per octave

    @property
    def hist_compute_dtype(self):
        import torch

        return torch.bfloat16 if self.hist_compute == "bf16" else None

    def octave_capacity(self, octave: int) -> int:
        if not self.octave_capacity_decay:
            return self.max_keypoints_per_octave
        # floor of 128 slots, but never above the configured per-octave cap
        return min(self.max_keypoints_per_octave,
                   max(self.max_keypoints_per_octave >> octave, 128))


@dataclass(frozen=True)
class OrbConfig(_Base):
    """ORB: oriented FAST + rotated BRIEF."""

    num_levels: int = 8
    scale_factor: float = 1.2
    fast_threshold: float = 0.08
    fast_arc: int = 9
    max_keypoints: int = 1024
    patch_size: int = 31
    brief_pairs: int = 256
    brief_seed: int = 0x9E3779B9
    harris_ranking: bool = True


@dataclass(frozen=True)
class MatchConfig(_Base):
    """Descriptor matching."""

    ratio: float = 0.8                  # Lowe ratio test
    mutual: bool = True                 # mutual-best cross check
    metric: str = "l2"                  # "l2" | "hamming"
    max_matches: int = 512
    tile: int = 256                     # tile of the streaming 2-NN kernel
    impl: str = "xla"                   # "xla": dense distance matrix;
    #                                     "pallas": the streaming 2-NN kernel


@dataclass(frozen=True)
class RansacConfig(_Base):
    """Batched-hypothesis RANSAC for the essential matrix."""

    num_hypotheses: int = 512
    sample_size: int = 8
    inlier_threshold: float = 1.5e-3
    seed: int = 0
    solver: str = "8pt"                 # "8pt" | "5pt"


@dataclass(frozen=True)
class BAConfig(_Base):
    """Sliding-window bundle adjustment."""

    max_cameras: int = 10
    max_landmarks: int = 8192
    max_observations: int = 16384
    iters: int = 10
    damping_init: float = 1e-3
    damping_up: float = 10.0
    damping_down: float = 0.1
    huber_delta: float = 5.0e-3
    solver: str = "schur_dense"         # "schur_dense" | "schur_cg" | "schur_mf"
    cg_iters: int = 32
    fix_first_camera: bool = True
    fix_gauge_scale: bool = True
    async_ba: bool = False


@dataclass(frozen=True)
class PoseGraphConfig(_Base):
    max_nodes: int = 256
    max_edges: int = 1024
    iters: int = 20
    damping: float = 1e-4
    loop_weight: float = 0.5
    solver: str = "auto"                # "dense" | "cg" | "auto"
    cg_iters: int = 96
    cg_threshold: int = 192


@dataclass(frozen=True)
class LoopConfig(_Base):
    """Loop-closure detection."""

    enabled: bool = True
    sub_keypoints: int = 256
    cosine_threshold: float = 0.85
    min_inliers: int = 25
    exclude_recent: int = 10
    cooldown_keyframes: int = 8
    db_capacity: int = 512
    sim3: bool = True
    consistency_rot_deg: float = 12.0
    consistency_trans: float = 0.1
    max_baseline_frac: float = 0.15
    max_scale: float = 1.5


@dataclass(frozen=True)
class SlamConfig(_Base):
    """Top-level engine config: composes every subsystem."""

    pyramid: PyramidConfig = field(default_factory=PyramidConfig)
    harris: HarrisConfig = field(default_factory=HarrisConfig)
    sift: SiftConfig = field(default_factory=SiftConfig)
    orb: OrbConfig = field(default_factory=OrbConfig)
    match: MatchConfig = field(default_factory=MatchConfig)
    ransac: RansacConfig = field(default_factory=RansacConfig)
    ba: BAConfig = field(default_factory=BAConfig)
    pose_graph: PoseGraphConfig = field(default_factory=PoseGraphConfig)
    loop: LoopConfig = field(default_factory=LoopConfig)
    frontend: str = "sift"              # "sift" | "orb" | "harris"
    keyframe_min_inliers: int = 40
    keyframe_max_gap: int = 5
    keyframe_min_gap: int = 1
    local_map_size: int = 1024
    map_landmarks: int = 16384
    track_gate: float = 0.05
    image_height: int = 376
    image_width: int = 1241

    @classmethod
    def from_json(cls, s: str) -> "SlamConfig":
        return cls.from_dict(json.loads(s))


DEFAULT_CONFIG = SlamConfig()

# Throughput profile: no initial 2x upsample, 3 octaves, capacities sized to
# KITTI-width frames, bf16 (mag, ori) patches into the descriptor kernels,
# per-octave candidate capacity halving. DEFAULT_CONFIG keeps the
# reference-parity behaviour.
FAST_CONFIG = SlamConfig(
    pyramid=PyramidConfig(initial_upsample=False, num_octaves=3),
    ba=BAConfig(max_landmarks=2048, max_observations=6144, async_ba=True),
    sift=SiftConfig(max_keypoints=2048, max_keypoints_per_octave=1024,
                    hist_compute="bf16", octave_capacity_decay=True),
    orb=OrbConfig(max_keypoints=2048),
    match=MatchConfig(max_matches=1024),
    local_map_size=2048,
    keyframe_min_inliers=25,
    keyframe_min_gap=2,
    keyframe_max_gap=8,
)

"""SIFT frontend: DoG detection -> localization -> orientation -> descriptors
(visualslam_tpu/models/sift.py), batched over frames.

Per octave (a Python loop): extrema candidates and their localization, the
candidates' patch origins in the (mag, ori) gradient levels (one origin per
candidate, shared by the orientation and descriptor stages), orientation
histograms (kernel) with peak spawning, the spawned keypoints' descriptors
(kernel, at the origin of the candidate each was spawned from) and their
normalization. The octaves' keypoints are then merged by response into the
final fixed capacity.

patch_impl "auto" / "pallas" run what "auto" selects on an accelerator in
the JAX package, on every device: the patch kernels, and under
hist_compute="bf16" bfloat16-rounded patches of 32 rows (float32 patches of
28 rows otherwise). The kernels read the gradient levels in place; their
plain versions cut the patches. The device decides only whether a kernel or
its plain version runs. patch_impl="xla" is the JAX package's opt-in XLA
formulation: float32 patches of 28 rows, tent-sampled windows and a soft
histogram computed in `hist_compute`'s dtype, in plain torch on any device.
Keypoints come back in input-image pixels (octave-0 pixels halved under the
2x upsample).

`detect_and_describe_sift_jit(img, pyr_cfg, cfg, kernels)` is the JAX
package's jitted SIFT frontend: on the card one captured CUDA graph per
shape key and configuration (`utils.graphs.GraphProgram`, seedless) over
the process's pyramid constants (`models.pyramid.pyramid_constants`); on
the CPU, and for the plain kernel set, the function run eagerly.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from visualslam_tpu_torch.models.pyramid import (
    ScaleSpace,
    build_pyramid,
    pyramid_constants,
)
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.blur import BlurBands
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.ops.cuda.descriptor import (
    descriptor_levels_ref,
    orient_hist_levels_ref,
)
from visualslam_tpu_torch.ops.extrema import detect_extrema
from visualslam_tpu_torch.ops.histograms import histogram_peaks
from visualslam_tpu_torch.ops.patches import patch_origins
from visualslam_tpu_torch.ops.resize import ResizeWeights
from visualslam_tpu_torch.utils.config import PyramidConfig, SiftConfig
from visualslam_tpu_torch.utils.graphs import GraphProgram
from visualslam_tpu_torch.utils.masked import top_k_select


class _OctaveKps(NamedTuple):
    yx_oct: torch.Tensor      # [B, K, 2] refined (y, x) in octave coords
    level: torch.Tensor       # [B, K] int32 DoG level
    scale_off: torch.Tensor   # [B, K] fitted scale offset ds
    orientation: torch.Tensor  # [B, K] degrees
    response: torch.Tensor    # [B, K] |contrast|
    valid: torch.Tensor       # [B, K] bool


def _take(a: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """a[b, idx[b, k], ...] for a [B, N, ...] and idx [B, K]."""
    rows = torch.arange(a.shape[0], device=a.device)[:, None]
    return a[rows, idx]


class PatchSource(NamedTuple):
    """Where an octave's patch kernels read: the gradient levels in place
    and, per candidate, its frame, gradient level and patch origin."""

    mag: torch.Tensor         # [B, Lg, H, W] float32
    ori: torch.Tensor         # [B, Lg, H, W] float32 degrees
    frame: torch.Tensor       # [B, K] int32
    glvl: torch.Tensor        # [B, K] int32 gradient level
    y0: torch.Tensor          # [B, K] int32 patch origin
    x0: torch.Tensor          # [B, K] int32
    patch: int                # patch rows (32 bf16, 28 f32)
    bf16: bool                # values rounded to bfloat16

    def at(self, idx: torch.Tensor):
        """(frame, glvl, y0, x0) of rows idx [B, K'] of each frame,
        flattened to [B * K'] int32 for the kernels."""
        return tuple(t.gather(1, idx).flatten() for t in
                     (self.frame, self.glvl, self.y0, self.x0))


def patch_source(ss: ScaleSpace, o: int, lvl: torch.Tensor, y: torch.Tensor,
                 x: torch.Tensor, cfg: SiftConfig) -> PatchSource:
    """The patch origins of octave o's candidates (lvl, y, x [B, K]), as
    ops/patches.crop_patches places them."""
    # the XLA formulation samples float32 patches whatever hist_compute is
    bf16 = cfg.hist_compute == "bf16" and cfg.patch_impl != "xla"
    # 32 rows for bf16 patches, 28 for f32; both cover the rotated window
    # radius win/2*sqrt(2)+0.5
    patch = 32 if bf16 else 28
    mag, ori = ss.grad_mag[o], ss.grad_ori[o]
    B, _, H, W = mag.shape
    y0, x0 = patch_origins(H, W, torch.stack([y, x], dim=-1).float(), patch)
    frame = torch.arange(B, dtype=torch.int32,
                         device=lvl.device)[:, None].expand_as(lvl)
    glvl = (lvl - ss.grad_level_offset).to(torch.int32)
    return PatchSource(mag, ori, frame, glvl, y0, x0, patch, bf16)


def patch_ops(cfg: SiftConfig, kernels: Kernels = KERNELS) -> tuple:
    """(orient_hist, descriptor) in the kernels' levels form: the kernels
    (their plain versions on CPU tensors), or under patch_impl="xla" the
    plain formulation with the histogram in `hist_compute`'s dtype."""
    if cfg.patch_impl in ("auto", "pallas"):
        return kernels.orient_hist, kernels.descriptor
    if cfg.patch_impl != "xla":
        raise ValueError(f"unknown patch_impl {cfg.patch_impl!r}")
    dt = cfg.hist_compute_dtype
    return (functools.partial(orient_hist_levels_ref, compute_dtype=dt),
            functools.partial(descriptor_levels_ref, compute_dtype=dt))


def _orientation_pass(src: PatchSource, lvl, y, x, offset, response, valid,
                      pyr_cfg: PyramidConfig, cfg: SiftConfig,
                      kernels: Kernels = KERNELS):
    """Up to cfg.max_orientations orientations per candidate, then the
    per-octave top-K by response among the spawned keypoints.

    src: the candidates' patch source; candidates lvl/y/x/response/valid
    [B, K] and offset [B, K, 3]. Returns (_OctaveKps, spawned row ->
    originating candidate [B, K])."""
    B, k = lvl.shape
    yx_int = torch.stack([y, x], dim=-1).float()
    lvl_f = lvl.float() + offset[..., 0]
    sigma_oct = pyr_cfg.base_sigma * pyr_cfg.k_factor ** lvl_f
    every = torch.arange(k, device=lvl.device).expand(B, k)
    hist = patch_ops(cfg, kernels)[0](
        src.mag, src.ori, *src.at(every), yx_int.flatten(0, 1),
        (cfg.orientation_sigma_scale * sigma_oct).flatten(), src.patch,
        src.bf16, cfg.num_orientation_bins).view(B, k, -1)
    angles, _, peak_valid = histogram_peaks(
        hist, cfg.max_orientations, cfg.orientation_peak_ratio, 360.0)

    # spawn: [B, K, P] -> [B, K * P]
    P = cfg.max_orientations
    yx_sp = (yx_int + offset[..., 1:3]).repeat_interleave(P, dim=1)
    lvl_sp = lvl.repeat_interleave(P, dim=1)
    ds_sp = offset[..., 0].repeat_interleave(P, dim=1)
    resp_sp = response.repeat_interleave(P, dim=1)
    valid_sp = valid.repeat_interleave(P, dim=1) & peak_valid.reshape(B, -1)
    ang_sp = angles.reshape(B, -1)

    # keep the octave capacity: top-K by response among the spawned, with a
    # tiny index tiebreak (ties keep the lower index first anyway)
    tiebreak = torch.arange(k * P, dtype=torch.float32,
                            device=lvl.device) * 1e-12
    idx, mask = top_k_select(resp_sp - tiebreak, valid_sp, k)
    zero = torch.zeros((), device=lvl.device)
    kps = _OctaveKps(
        yx_oct=_take(yx_sp, idx) * mask[..., None],
        level=torch.where(mask, lvl_sp.gather(1, idx), 1),
        scale_off=torch.where(mask, ds_sp.gather(1, idx), zero),
        orientation=torch.where(mask, ang_sp.gather(1, idx), zero),
        response=torch.where(mask, resp_sp.gather(1, idx), zero),
        valid=mask,
    )
    return kps, idx // P


def describe_octave(src: PatchSource, cand_idx, kps: _OctaveKps,
                    cfg: SiftConfig, kernels: Kernels = KERNELS) -> torch.Tensor:
    """128-D descriptors [B, K, D] of one octave's keypoints, sampled at the
    patch origin of the candidate each was spawned from (cand_idx)."""
    B, K = cand_idx.shape
    width, nbins = cfg.descriptor_width, cfg.descriptor_bins
    desc = patch_ops(cfg, kernels)[1](
        src.mag, src.ori, *src.at(cand_idx),
        kps.yx_oct.flatten(0, 1).contiguous(),
        kps.orientation.flatten().contiguous(), src.patch, src.bf16,
        width, nbins).view(B, K, -1)

    def normalize(d):
        if cfg.descriptor_norm == "max":     # the reference's quirk (f)
            return d / d.amax(dim=-1, keepdim=True).clamp_min(1e-12)
        return d / torch.linalg.vector_norm(d, dim=-1,
                                            keepdim=True).clamp_min(1e-12)

    desc = normalize(torch.clamp(normalize(desc), max=cfg.descriptor_clamp))
    return desc * kps.valid[..., None]


def octave_result(kps: _OctaveKps, desc: torch.Tensor, o: int,
                  pyr_cfg: PyramidConfig) -> tuple:
    """(keypoints, descriptors, factor, sigma_base, octave) of octave o, as
    merge_octaves takes them; factor maps octave pixels to input pixels."""
    factor = (2.0 ** o) * (0.5 if pyr_cfg.initial_upsample else 1.0)
    lvl_f = kps.level.float() + kps.scale_off
    sigma_base = factor * pyr_cfg.base_sigma * pyr_cfg.k_factor ** lvl_f
    return kps, desc, factor, sigma_base, torch.full_like(kps.level, o)


def merge_octaves(per_oct: list, cfg: SiftConfig) -> Features:
    """The global top cfg.max_keypoints by response over the octaves."""
    resp_all = torch.cat([t[0].response for t in per_oct], dim=1)
    valid_all = torch.cat([t[0].valid for t in per_oct], dim=1)
    idx, mask = top_k_select(resp_all, valid_all, cfg.max_keypoints)

    def take(field_fn):
        cat = torch.cat([field_fn(t) for t in per_oct], dim=1)
        picked = _take(cat, idx)
        m = mask.view(mask.shape + (1,) * (picked.ndim - 2))
        return torch.where(m, picked, torch.zeros_like(picked))

    kps = Keypoints(
        yx=take(lambda t: t[0].yx_oct * t[2]),
        yx_oct=take(lambda t: t[0].yx_oct),
        octave=take(lambda t: t[4]),
        level=take(lambda t: t[0].level),
        sigma=take(lambda t: t[3]),
        orientation=take(lambda t: t[0].orientation),
        response=take(lambda t: t[0].response),
        valid=mask,
    )
    return Features(kps, take(lambda t: t[1]))


def detect_and_describe_sift(img: torch.Tensor, pyr_cfg: PyramidConfig,
                             cfg: SiftConfig, bands: BlurBands | None = None,
                             kernels: Kernels = KERNELS,
                             resize: ResizeWeights | None = None) -> Features:
    """SIFT frontend on [B, H, W] float frames -> Features with a leading
    frame axis ([B, cfg.max_keypoints, ...]). `kernels` is ops.cuda.KERNELS
    (the kernel path) or ops.cuda.PLAIN (the plain path); `bands` and
    `resize` hold the pyramid's constants across calls."""
    if cfg.descriptor_norm not in ("l2", "max"):
        raise ValueError(f"unknown descriptor_norm {cfg.descriptor_norm!r}")
    ss = build_pyramid(img, pyr_cfg, bands, kernels, resize)
    per_oct = []
    for o in range(pyr_cfg.num_octaves):
        lvl, y, x, offset, resp, valid = detect_extrema(
            ss.dog[o], cfg, cfg.octave_capacity(o), kernels)
        src = patch_source(ss, o, lvl, y, x, cfg)
        kps, cand_idx = _orientation_pass(src, lvl, y, x, offset, resp,
                                          valid, pyr_cfg, cfg, kernels)
        desc = describe_octave(src, cand_idx, kps, cfg, kernels)
        per_oct.append(octave_result(kps, desc, o, pyr_cfg))
    return merge_octaves(per_oct, cfg)


def _detect_and_describe_sift(x: tuple, cfg: tuple) -> Features:
    img, = x
    (pyr_cfg, sift_cfg), kernels = cfg
    bands, resize = pyramid_constants(pyr_cfg, img.device)
    return detect_and_describe_sift(img, pyr_cfg, sift_cfg, bands, kernels,
                                    resize)


_SIFT = GraphProgram(_detect_and_describe_sift, seeded=False)


def detect_and_describe_sift_jit(img: torch.Tensor, pyr_cfg: PyramidConfig,
                                 cfg: SiftConfig,
                                 kernels: Kernels = KERNELS) -> Features:
    """detect_and_describe_sift as one captured graph per shape key and
    (pyr_cfg, cfg, kernels); the features are the caller's (copies of the
    graph's outputs)."""
    return _SIFT((img,), ((pyr_cfg, cfg), kernels))


detect_and_describe_sift_jit.program = _SIFT

"""SIFT frontend: DoG detection -> localization -> orientation -> descriptors
(visualslam_tpu/models/sift.py), batched over frames.

Per octave (a Python loop): extrema candidates and their localization, ONE
(mag, ori) patch crop per candidate shared by the orientation and
descriptor stages, orientation histograms (kernel) with peak spawning, the
spawned keypoints' descriptors (kernel) and their normalization. The
octaves' keypoints are then merged by response into the final fixed
capacity.

The port runs what "auto" selects on an accelerator in the JAX package, on
every device: the fused extrema candidates, the patch kernels, and under
hist_compute="bf16" bfloat16 patches of 32 rows (float32 patches of 28 rows
otherwise). The device decides only whether a kernel or its plain version
runs.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from visualslam_tpu_torch.models.pyramid import build_pyramid
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.blur import BlurBands
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.ops.extrema import detect_extrema
from visualslam_tpu_torch.ops.histograms import histogram_peaks
from visualslam_tpu_torch.ops.patches import crop_patches
from visualslam_tpu_torch.utils.config import PyramidConfig, SiftConfig
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


def _orientation_pass(patches, py0, px0, lvl, y, x, offset, response, valid,
                      pyr_cfg: PyramidConfig, cfg: SiftConfig,
                      kernels: Kernels = KERNELS):
    """Up to cfg.max_orientations orientations per candidate, then the
    per-octave top-K by response among the spawned keypoints.

    patches [B, K, 2, Ph, Pw] with origins py0/px0 [B, K]; candidates
    lvl/y/x/response/valid [B, K] and offset [B, K, 3]. Returns
    (_OctaveKps, spawned row -> originating candidate [B, K])."""
    B, k = lvl.shape
    yx_int = torch.stack([y, x], dim=-1).float()
    lvl_f = lvl.float() + offset[..., 0]
    sigma_oct = pyr_cfg.base_sigma * pyr_cfg.k_factor ** lvl_f
    hist = kernels.orient_hist(
        patches.flatten(0, 1), py0.flatten(), px0.flatten(),
        yx_int.flatten(0, 1),
        (cfg.orientation_sigma_scale * sigma_oct).flatten(),
        cfg.num_orientation_bins).view(B, k, -1)
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


def describe_octave(patches, py0, px0, cand_idx, kps: _OctaveKps,
                    cfg: SiftConfig, kernels: Kernels = KERNELS) -> torch.Tensor:
    """128-D descriptors [B, K, D] of one octave's keypoints, sampled from
    the same patches as the orientation pass (re-indexed by cand_idx)."""
    B, K = cand_idx.shape
    width, nbins = cfg.descriptor_width, cfg.descriptor_bins
    desc = kernels.descriptor(
        _take(patches, cand_idx).flatten(0, 1),
        py0.gather(1, cand_idx).flatten(), px0.gather(1, cand_idx).flatten(),
        kps.yx_oct.flatten(0, 1).contiguous(),
        kps.orientation.flatten().contiguous(),
        width, nbins).view(B, K, -1)

    def normalize(d):
        return d / torch.linalg.vector_norm(d, dim=-1,
                                            keepdim=True).clamp_min(1e-12)

    desc = normalize(torch.clamp(normalize(desc), max=cfg.descriptor_clamp))
    return desc * kps.valid[..., None]


def detect_and_describe_sift(img: torch.Tensor, pyr_cfg: PyramidConfig,
                             cfg: SiftConfig, bands: BlurBands | None = None,
                             kernels: Kernels = KERNELS) -> Features:
    """SIFT frontend on [B, H, W] float frames -> Features with a leading
    frame axis ([B, cfg.max_keypoints, ...]). `kernels` is ops.cuda.KERNELS
    (the kernel path) or ops.cuda.PLAIN (the plain path)."""
    if cfg.patch_impl not in ("auto", "pallas"):
        raise NotImplementedError(
            f"patch_impl={cfg.patch_impl!r} is not ported yet; the port runs "
            "the fused patch kernels")
    if cfg.descriptor_norm != "l2":
        raise NotImplementedError(
            f"descriptor_norm={cfg.descriptor_norm!r} is not ported yet")
    ss = build_pyramid(img, pyr_cfg, bands, kernels)
    patch_dtype = torch.bfloat16 if cfg.hist_compute == "bf16" else None
    # 32 rows for bf16 patches, 28 for f32; both cover the rotated window
    # radius win/2*sqrt(2)+0.5
    ph = 32 if patch_dtype is not None else 28

    per_oct = []
    for o in range(pyr_cfg.num_octaves):
        lvl, y, x, offset, resp, valid = detect_extrema(
            ss.dog[o], cfg, cfg.octave_capacity(o), kernels)
        mag_ori = torch.stack([ss.grad_mag[o], ss.grad_ori[o]], dim=1)
        if patch_dtype is not None:
            mag_ori = mag_ori.to(patch_dtype)          # [B, 2, Lg, H, W]
        glvl = (lvl - ss.grad_level_offset).long()
        yx_int = torch.stack([y, x], dim=-1).float()
        patches, py0, px0 = crop_patches(mag_ori, glvl, yx_int, ph)
        kps, cand_idx = _orientation_pass(patches, py0, px0, lvl, y, x,
                                          offset, resp, valid, pyr_cfg, cfg,
                                          kernels)
        desc = describe_octave(patches, py0, px0, cand_idx, kps, cfg, kernels)
        factor = 2.0 ** o
        lvl_f = kps.level.float() + kps.scale_off
        sigma_base = factor * pyr_cfg.base_sigma * pyr_cfg.k_factor ** lvl_f
        per_oct.append((kps, desc, factor, sigma_base,
                        torch.full_like(kps.level, o)))

    # merge octaves: global top max_keypoints by response
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

"""Per-keypoint orientation histogram and SIFT descriptor: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replace visualslam_tpu/ops/pallas/descriptor.py `pallas_orient_hist`
(`_orient_kernel`) and `pallas_descriptor` (`_desc_kernel`). Both read one
(mag, ori) patch per keypoint from ops/patches.crop_patches, [K, 2, Ph, Pw]
in float32 (Ph = 28) or bfloat16 (Ph = 32, the FAST profile).

On the H100 neither kernel is bound by bytes or FLOPs at the frontend's
sizes: a keypoint's grid touches a few patch rows (256 samples x 4 taps)
and its histogram is ~256 x 12 multiply-adds, while the TPU kernels were
shaped around feeding the matrix unit with tent-weight products. The CUDA
kernels (csrc/descriptor.cu) give each keypoint one block and each sample
one thread, which reads its four taps directly; the histogram bins are then
summed from shared memory by one thread per bin in a fixed order, so the
result does not vary between runs and differs from the plain version only
by summation order.

For a CUDA tensor the wrappers launch the kernels; for a CPU tensor they run
the plain versions; anything else raises.
"""

from __future__ import annotations

import ctypes
import math

import torch

from visualslam_tpu_torch.ops.cuda import build
from visualslam_tpu_torch.ops.histograms import (
    gaussian_window,
    mod,
    soft_histogram,
)
from visualslam_tpu_torch.ops.patches import rotated_grid, tent_sample_patches

WIN = 16            # sampling window side (16 x 16 samples)


def orient_hist_ref(patches, y0, x0, yx, sigma, nbins: int = 36):
    """Plain version: the integer 16x16 window about yx (tent weights reduce
    to one-hots), Gaussian-weighted magnitude, circular soft histogram.
    patches [K, 2, Ph, Pw]; y0, x0 [K]; yx [K, 2]; sigma [K] -> [K, nbins]."""
    K = patches.shape[0]
    offs = torch.arange(WIN, dtype=torch.float32, device=yx.device) - WIN // 2
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([gy, gx], dim=-1)[None]              # [1, S, S, 2]
    both = tent_sample_patches(patches, y0, x0, yx[:, None, None, :] + grid)
    w = gaussian_window(WIN, sigma.clamp_min(1e-6))          # [K, S, S]
    return soft_histogram(both[..., 1].reshape(K, -1),
                          (both[..., 0] * w).reshape(K, -1), nbins, 360.0)


def descriptor_ref(patches, y0, x0, yx, angle, width: int = 4,
                   nbins: int = 8):
    """Plain version: rotated 16x16 grid, bilinear (mag, ori), spatial
    Gaussian (sigma 8) x magnitude, orientation relative to the keypoint
    angle, width x width regions x nbins circular bins, unnormalized.
    patches [K, 2, Ph, Pw]; y0, x0 [K]; yx [K, 2]; angle [K] degrees
    -> [K, width * width * nbins] (region-major)."""
    K = patches.shape[0]
    coords = rotated_grid(yx, angle, WIN)
    both = tent_sample_patches(patches, y0, x0, coords)      # [K, S, S, 2]
    rel = mod(both[..., 1] - angle[:, None, None], 360.0)
    cell = WIN // width
    w_spatial = gaussian_window(WIN, torch.tensor(WIN / 2.0,
                                                  device=yx.device))

    def to_regions(a):   # [K, S, S] -> [K, regions, cell * cell]
        a = a.reshape(K, width, cell, width, cell)
        return a.permute(0, 1, 3, 2, 4).reshape(K, width * width, cell * cell)

    hist = soft_histogram(to_regions(rel), to_regions(both[..., 0] * w_spatial),
                          nbins, 360.0)
    return hist.reshape(K, width * width * nbins)


def _check(patches, y0, x0, yx, per_kp, name: str):
    K = patches.shape[0]
    if patches.dtype not in (torch.float32, torch.bfloat16) or \
            patches.ndim != 4 or patches.shape[1] != 2:
        raise ValueError(f"{name}: patches must be float32/bfloat16 "
                         f"[K, 2, Ph, Pw], got {patches.dtype} "
                         f"{tuple(patches.shape)}")
    for t, dtype, shape in ((y0, torch.int32, (K,)), (x0, torch.int32, (K,)),
                            (yx, torch.float32, (K, 2)),
                            (per_kp, torch.float32, (K,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (patches, y0, x0, yx, per_kp):
        if t.device != patches.device:
            raise ValueError(f"{name}: all inputs must be on {patches.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")


def orient_hist(patches, y0, x0, yx, sigma, nbins: int = 36):
    """Orientation histograms [K, nbins] float32 (contract of
    `orient_hist_ref`). yx are the integer window centres."""
    if patches.device.type == "cpu":
        return orient_hist_ref(patches, y0, x0, yx, sigma, nbins)
    if patches.device.type != "cuda":
        raise ValueError(f"orient_hist: unsupported device {patches.device}")
    _check(patches, y0, x0, yx, sigma, "orient_hist")
    if not 0 < nbins <= 256:
        raise ValueError(f"orient_hist: nbins {nbins} outside 1..256")
    K, _, ph, pw = patches.shape
    out = torch.empty((K, nbins), dtype=torch.float32, device=patches.device)
    lib = _lib()
    with torch.cuda.device(patches.device):
        rc = lib.orient_hist(
            build.ptr(patches), int(patches.dtype == torch.bfloat16),
            build.ptr(y0), build.ptr(x0), build.ptr(yx), build.ptr(sigma),
            build.ptr(out), K, ph, pw, nbins,
            build.stream_handle(patches.device))
    build.check_launch(rc, "orient_hist")
    orient_hist.launches += 1
    return out


def descriptor(patches, y0, x0, yx, angle, width: int = 4, nbins: int = 8):
    """Unnormalized descriptors [K, width * width * nbins] float32
    (contract of `descriptor_ref`)."""
    if patches.device.type == "cpu":
        return descriptor_ref(patches, y0, x0, yx, angle, width, nbins)
    if patches.device.type != "cuda":
        raise ValueError(f"descriptor: unsupported device {patches.device}")
    _check(patches, y0, x0, yx, angle, "descriptor")
    D = width * width * nbins
    if WIN % width or not 0 < D <= 256:
        raise ValueError(f"descriptor: unsupported width {width} x "
                         f"nbins {nbins}")
    K, _, ph, pw = patches.shape
    # cos and sin by the same tensor ops as the plain version's rotated grid,
    # so both sample at the same positions bit for bit (see descriptor.cu)
    theta = angle * (math.pi / 180.0)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    out = torch.empty((K, D), dtype=torch.float32, device=patches.device)
    lib = _lib()
    with torch.cuda.device(patches.device):
        rc = lib.descriptor(
            build.ptr(patches), int(patches.dtype == torch.bfloat16),
            build.ptr(y0), build.ptr(x0), build.ptr(yx), build.ptr(angle),
            build.ptr(rot), build.ptr(out), K, ph, pw, width, nbins,
            build.stream_handle(patches.device))
    build.check_launch(rc, "descriptor")
    descriptor.launches += 1
    return out


orient_hist.launches = 0
descriptor.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load_library("descriptor")
    head = [ctypes.c_void_p, ctypes.c_int]
    lib.orient_hist.argtypes = (head + [ctypes.c_void_p] * 5
                                + [ctypes.c_int] * 4 + [ctypes.c_void_p])
    lib.descriptor.argtypes = (head + [ctypes.c_void_p] * 6
                               + [ctypes.c_int] * 5 + [ctypes.c_void_p])
    lib.orient_hist.restype = ctypes.c_int
    lib.descriptor.restype = ctypes.c_int
    return lib

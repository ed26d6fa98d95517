"""Per-keypoint orientation histogram and SIFT descriptor: the CUDA kernels'
wrappers and their plain PyTorch versions.

Replace visualslam_tpu/ops/pallas/descriptor.py `pallas_orient_hist`
(`_orient_kernel`) and `pallas_descriptor` (`_desc_kernel`), applied to the
(mag, ori) patches that ops/patches.crop_patches cuts from the gradient
levels: [K, 2, Ph, Pw] in float32 (Ph = 28) or bfloat16 (Ph = 32, the FAST
profile).

Two forms of each function:

  - `orient_hist_ref`, `descriptor_ref` take the patches ([K, 2, Ph, Pw]
    and their origins y0, x0): the plain versions of the TPU kernels'
    contract, held against the Pallas kernels by the CPU tests;
  - `orient_hist`, `descriptor` (the wrappers) and `orient_hist_levels_ref`,
    `descriptor_levels_ref` (their plain versions) take the gradient levels
    themselves, mag and ori [B, Lg, H, W] float32, and per keypoint its
    frame, gradient level and patch origin. The plain versions cut the
    patches (ops/patches.gather_patches of the stacked, optionally
    bf16-rounded levels) and call the patch form; the kernels
    (csrc/descriptor.cu) read the levels in place, so the stack, the cast
    and the crop never happen on the kernel path.

On the H100 the kernels (csrc/descriptor.cu) give each keypoint one warp
of a persistent grid: the warp stages the keypoint's box of level samples
into shared memory with cp.async in a ring of two, each lane takes 8
samples, and each sample adds to the at most three bins its tent reaches,
in a fixed order with no atomics. The card takes the frontend's shapes:
up to 64 orientation bins, and 4 x 4 regions x 8 bins for the descriptor;
the plain versions take any.

For a CUDA tensor the wrappers launch the kernels; for a CPU tensor they run
the plain versions; anything else raises. A keypoint whose frame, level or
origin is out of range gives a row of NaN (the kernel reads nothing for it):
checking the indices on the host would cost a device sync per call.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from visualslam_tpu_torch.ops.cuda import build
from visualslam_tpu_torch.ops.histograms import (
    gaussian_window,
    mod,
    soft_histogram,
)
from visualslam_tpu_torch.ops.patches import (
    gather_patches,
    patch_shape,
    rotated_grid,
    tent_sample_patches,
)

WIN = 16            # sampling window side (16 x 16 samples)


def orient_hist_ref(patches, y0, x0, yx, sigma, nbins: int = 36,
                    compute_dtype=None):
    """Plain version: the integer 16x16 window about yx (tent weights reduce
    to one-hots), Gaussian-weighted magnitude, circular soft histogram.
    patches [K, 2, Ph, Pw]; y0, x0 [K]; yx [K, 2]; sigma [K] -> [K, nbins].
    compute_dtype: the histogram's (models/sift's patch_impl="xla")."""
    K = patches.shape[0]
    offs = torch.arange(WIN, dtype=torch.float32, device=yx.device) - WIN // 2
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([gy, gx], dim=-1)[None]              # [1, S, S, 2]
    both = tent_sample_patches(patches, y0, x0, yx[:, None, None, :] + grid)
    w = gaussian_window(WIN, sigma.clamp_min(1e-6))          # [K, S, S]
    return soft_histogram(both[..., 1].reshape(K, -1),
                          (both[..., 0] * w).reshape(K, -1), nbins, 360.0,
                          compute_dtype)


def descriptor_ref(patches, y0, x0, yx, angle, width: int = 4,
                   nbins: int = 8, compute_dtype=None):
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
    w_spatial = gaussian_window(WIN, torch.full((), WIN / 2.0,
                                                device=yx.device))

    def to_regions(a):   # [K, S, S] -> [K, regions, cell * cell]
        a = a.reshape(K, width, cell, width, cell)
        return a.permute(0, 1, 3, 2, 4).reshape(K, width * width, cell * cell)

    hist = soft_histogram(to_regions(rel), to_regions(both[..., 0] * w_spatial),
                          nbins, 360.0, compute_dtype)
    return hist.reshape(K, width * width * nbins)


def level_patches(mag, ori, frame, glvl, y0, x0, patch: int, bf16: bool):
    """The patches the kernels read in place: [K, 2, Ph, Pw] cut at the
    given origins from the stacked levels, bfloat16 when bf16."""
    stack = torch.stack([mag, ori], dim=1)                   # [B, 2, Lg, H, W]
    if bf16:
        stack = stack.to(torch.bfloat16)
    return gather_patches(stack, frame, glvl, y0, x0, patch)


def orient_hist_levels_ref(mag, ori, frame, glvl, y0, x0, yx, sigma,
                           patch: int, bf16: bool, nbins: int = 36,
                           compute_dtype=None):
    """Plain version of `orient_hist`: `level_patches`, then
    `orient_hist_ref`."""
    return orient_hist_ref(
        level_patches(mag, ori, frame, glvl, y0, x0, patch, bf16),
        y0, x0, yx, sigma, nbins, compute_dtype)


def descriptor_levels_ref(mag, ori, frame, glvl, y0, x0, yx, angle,
                          patch: int, bf16: bool, width: int = 4,
                          nbins: int = 8, compute_dtype=None):
    """Plain version of `descriptor`: `level_patches`, then
    `descriptor_ref`."""
    return descriptor_ref(
        level_patches(mag, ori, frame, glvl, y0, x0, patch, bf16),
        y0, x0, yx, angle, width, nbins, compute_dtype)


def staged_boxes(yx, y0, x0, angle, ph: int, pw: int):
    """The box of patch taps the kernel stages per keypoint, as
    csrc/descriptor.cu `finish_kp` computes it: (first row, first column,
    rows, columns), each [K] int64. Every tap with a non-zero weight lies
    in it. angle None: the orientation window (offsets -8..7); otherwise
    the descriptor's rotated grid."""
    if angle is None:
        lo = torch.full_like(yx[:, 0], -(WIN // 2))
        hi = torch.full_like(yx[:, 0], WIN // 2 - 1)
    else:
        theta = angle * (math.pi / 180.0)
        r = (7.5 * (torch.cos(theta).abs() + torch.sin(theta).abs())
             * (1.0 + 1e-5) + 1e-4)
        lo, hi = -r, r

    def extent(c, o, n):
        a = ((c + lo) - o.float()).clamp(0.0, n - 1.0)
        b = ((c + hi) - o.float()).clamp(0.0, n - 1.0)
        first = torch.floor(a).long()
        return first, torch.ceil(b).long().clamp(max=n - 1) - first + 1

    r0, nr = extent(yx[:, 0], y0, ph)
    c0, nc = extent(yx[:, 1], x0, pw)
    return r0, c0, nr, nc


def _check(name, mag, ori, frame, glvl, y0, x0, yx, per_kp, patch):
    if mag.dtype != torch.float32 or mag.ndim != 4 or ori.shape != mag.shape \
            or ori.dtype != torch.float32:
        raise ValueError(f"{name}: mag and ori must be float32 [B, L, H, W] "
                         f"of one shape, got {mag.dtype} {tuple(mag.shape)} "
                         f"and {ori.dtype} {tuple(ori.shape)}")
    K = yx.shape[0]
    for t, dtype, shape in ((frame, torch.int32, (K,)),
                            (glvl, torch.int32, (K,)),
                            (y0, torch.int32, (K,)), (x0, torch.int32, (K,)),
                            (yx, torch.float32, (K, 2)),
                            (per_kp, torch.float32, (K,))):
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: expected {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    for t in (mag, ori, frame, glvl, y0, x0, yx, per_kp):
        if t.device != mag.device:
            raise ValueError(f"{name}: all inputs must be on {mag.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: inputs must be contiguous")
    if not 0 < patch:
        raise ValueError(f"{name}: patch {patch} must be positive")


def _launch(fn, name, mag, ori, frame, glvl, y0, x0, yx, per_kp, extra,
            patch, bf16, slots, tail):
    B, L, H, W = mag.shape
    ph, pw = patch_shape(H, W, patch)
    K = yx.shape[0]
    out = torch.empty((K, slots), dtype=torch.float32, device=mag.device)
    with torch.cuda.device(mag.device):
        rc = fn(build.ptr(mag), build.ptr(ori), build.ptr(frame),
                build.ptr(glvl), build.ptr(y0), build.ptr(x0), build.ptr(yx),
                build.ptr(per_kp), *extra, build.ptr(out), K, B, L, H, W,
                ph, pw, *tail, int(bf16), build.stream_handle(mag.device))
    build.check_launch(rc, name)
    return out


def _device(name, mag) -> str:
    if mag.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {mag.device}")
    return mag.device.type


def orient_hist(mag, ori, frame, glvl, y0, x0, yx, sigma, patch: int,
                bf16: bool, nbins: int = 36):
    """Orientation histograms [K, nbins] float32 (contract of
    `orient_hist_levels_ref`). mag, ori [B, Lg, H, W]; frame, glvl, y0, x0
    [K] int32; yx [K, 2] the integer window centres; sigma [K]."""
    if _device("orient_hist", mag) == "cpu":
        return orient_hist_levels_ref(mag, ori, frame, glvl, y0, x0, yx,
                                      sigma, patch, bf16, nbins)
    _check("orient_hist", mag, ori, frame, glvl, y0, x0, yx, sigma, patch)
    if not 3 <= nbins <= 64:
        raise ValueError(f"orient_hist: nbins {nbins} outside 3..64 (the "
                         "kernel's lane pairs)")
    out = _launch(_lib().orient_hist, "orient_hist", mag, ori, frame, glvl,
                  y0, x0, yx, sigma, (), patch, bf16, nbins, (nbins,))
    orient_hist.launches += 1
    return out


def descriptor(mag, ori, frame, glvl, y0, x0, yx, angle, patch: int,
               bf16: bool, width: int = 4, nbins: int = 8):
    """Unnormalized descriptors [K, width * width * nbins] float32
    (contract of `descriptor_levels_ref`). frame, glvl, y0, x0 are those of
    the candidate the keypoint was spawned from; yx [K, 2] its refined
    centre; angle [K] degrees."""
    if _device("descriptor", mag) == "cpu":
        return descriptor_levels_ref(mag, ori, frame, glvl, y0, x0, yx,
                                     angle, patch, bf16, width, nbins)
    _check("descriptor", mag, ori, frame, glvl, y0, x0, yx, angle, patch)
    if (width, nbins) != (4, 8):
        raise ValueError(f"descriptor: the kernel computes 4 x 4 regions x "
                         f"8 bins, not width {width} x nbins {nbins}")
    # cos and sin by the same tensor ops as the plain version's rotated grid,
    # so both sample at the same positions bit for bit (see descriptor.cu)
    theta = angle * (math.pi / 180.0)
    rot = torch.stack([torch.cos(theta), torch.sin(theta)], dim=-1)
    out = _launch(_lib().descriptor, "descriptor", mag, ori, frame, glvl, y0,
                  x0, yx, angle, (build.ptr(rot),), patch, bf16, 128, ())
    descriptor.launches += 1
    return out


orient_hist.launches = 0
descriptor.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("descriptor")
    ptrs = [ctypes.c_void_p] * 9          # levels, indices, yx, per-keypoint
    lib.orient_hist.argtypes = (ptrs + [ctypes.c_int] * 9
                                + [ctypes.c_void_p])
    lib.descriptor.argtypes = (ptrs + [ctypes.c_void_p] + [ctypes.c_int] * 8
                               + [ctypes.c_void_p])
    lib.orient_hist.restype = ctypes.c_int
    lib.descriptor.restype = ctypes.c_int
    return lib

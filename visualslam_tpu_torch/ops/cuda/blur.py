"""Multi-sigma separable Gaussian blur: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces visualslam_tpu/ops/pallas/blur.py `pallas_blur_stack`. On the H100
the blur is memory-bound (~36 MB of traffic per 376 x 1248 frame for
~0.5 GFLOP); the kernel (csrc/blur.cu) runs the y pass and then the x pass,
each block staging its slab through numpy's "symmetric" index map in
shared memory (no padded copy, no transpose), and writes all S sigma
planes from one y-pass slab. Both versions accumulate in tap order with a
rounded product and a rounded add per tap, so they agree bit for bit.

`blur_stack` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes

import torch

from visualslam_tpu_torch.ops.blur import pad_symmetric
from visualslam_tpu_torch.ops.cuda import build

MAX_SIGMAS = 8      # sigmas per call the kernel holds in registers


def _conv(x: torch.Tensor, taps: torch.Tensor, dim: int) -> torch.Tensor:
    """sum_k taps[s, k] * x_padded[..., k : k + n, ...] along `dim` of
    x [B, S or 1, H, W], symmetric-padded by R, in tap order."""
    S, K = taps.shape
    R = (K - 1) // 2
    n = x.shape[dim]
    xp = pad_symmetric(x, dim, R)
    t = taps.reshape(1, S, K, 1, 1)
    acc = t[:, :, 0] * xp.narrow(dim, 0, n)
    for k in range(1, K):
        acc = acc + t[:, :, k] * xp.narrow(dim, k, n)
    return acc


def blur_stack_ref(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Plain version: img [B, H, W] float32, taps [S, K] (each sigma's taps
    centred and zero-padded to K = 2R + 1) -> [B, S, H, W]: the y pass,
    then the x pass, each symmetric-padded by R."""
    return _conv(_conv(img[:, None], taps, 2), taps, 3)


def blur_stack(img: torch.Tensor, taps: torch.Tensor) -> torch.Tensor:
    """Blur [B, H, W] float32 frames to the S sigmas of `taps` [S, K] ->
    [B, S, H, W]. Same contract as `blur_stack_ref`."""
    if img.device.type == "cpu" and taps.device.type == "cpu":
        return blur_stack_ref(img, taps)
    if img.device.type != "cuda" or taps.device != img.device:
        raise ValueError(f"blur_stack: unsupported devices {img.device}, "
                         f"{taps.device}")
    if (img.dtype != torch.float32 or taps.dtype != torch.float32
            or img.ndim != 3 or taps.ndim != 2
            or not 1 <= taps.shape[0] <= MAX_SIGMAS or taps.shape[1] % 2 == 0):
        raise ValueError("blur_stack: expects float32 [B, H, W] and [S, K] "
                         f"with S <= {MAX_SIGMAS} and K odd, got {img.dtype} "
                         f"{tuple(img.shape)} and {taps.dtype} "
                         f"{tuple(taps.shape)}")
    if not (img.is_contiguous() and taps.is_contiguous()):
        raise ValueError("blur_stack: img and taps must be contiguous")
    B, H, W = img.shape
    S, K = taps.shape
    tmp = torch.empty((B, S, H, W), dtype=torch.float32, device=img.device)
    out = torch.empty_like(tmp)
    lib = _lib()
    with torch.cuda.device(img.device):
        rc = lib.blur_stack(build.ptr(img), build.ptr(taps), build.ptr(tmp),
                            build.ptr(out), B, H, W, S, K,
                            build.stream_handle(img.device))
    build.check_launch(rc, "blur_stack")
    blur_stack.launches += 1
    return out


blur_stack.launches = 0


def _lib() -> ctypes.CDLL:
    lib = build.load_library("blur")
    fn = lib.blur_stack
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib

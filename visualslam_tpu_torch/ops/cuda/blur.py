"""Multi-sigma separable Gaussian blur: the CUDA kernel's wrapper and its
plain PyTorch version.

Replaces visualslam_tpu/ops/pallas/blur.py `pallas_blur_stack`. On the H100
the blur is bound by its arithmetic: with the multiply and the add of each
tap rounded apart (the plain version's arithmetic, which keeps the two
equal bit for bit) octave 0 of a 16-frame batch is 4.9 G f32 instructions
against 210 MB of input and output. The kernel (csrc/blur.cu) is one
launch: a block stages its input slab once through numpy's "symmetric"
index map, then per sigma runs the y pass over that sigma's non-zero taps
into shared memory and the x pass from there, each thread keeping a
register window, so the y pass never reaches device memory and the wrapper
allocates only the output. Both versions accumulate in tap order with a
rounded product and a rounded add per tap; the kernel skips the zero taps
outside each sigma's span, which leaves a finite sum unchanged.

`blur_stack` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from visualslam_tpu_torch.ops.blur import pad_symmetric
from visualslam_tpu_torch.ops.cuda import build

MAX_SIGMAS = 8      # sigmas per call (rows of the kernel's tap table)


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
    out = torch.empty((B, S, H, W), dtype=torch.float32, device=img.device)
    with build.on_device(img.device):
        rc = _lib().blur_stack(img.data_ptr(), taps.data_ptr(),
                               out.data_ptr(), B, H, W, S, K,
                               build.stream_handle(img.device))
    build.check_launch(rc, "blur_stack")
    blur_stack.launches += 1
    return out


blur_stack.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("blur")
    fn = lib.blur_stack
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib

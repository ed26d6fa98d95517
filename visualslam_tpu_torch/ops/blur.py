"""Gaussian blurs (visualslam_tpu/ops/blur.py) and the blur's constants.

`blur_mode="matmul"`: multi-sigma blur as banded-Toeplitz matrix products.
`blur_mode="pallas"` runs the separable-convolution kernel of
ops/cuda/blur.py on the tap table `BlurBands.taps` holds. `blur_mode="conv"`
(`blur_stack`) and `"incremental"` (`incremental_blur_stack`) and the
one-sigma `gaussian_blur` are separable convolutions, here `F.conv2d` in
float32 (cuDNN's TF32 off, frontend.detect_and_describe), as the JAX
package runs them outside any Pallas kernel; the `box_filter` sum adds
shifted slices in the window's order.

One image blurred to S sigmas at once: a symmetric-padded x pass and a
symmetric-padded y pass, each one dense product against [S, n + 2R, n]
band matrices whose column j holds sigma s's taps centred on padded row
j + R. The JAX package runs both products outside any Pallas kernel, so
here they are plain `torch.matmul` calls; in float32 with TF32 off
(frontend.detect_and_describe) they agree with the JAX package to float32
rounding. The band matrices are constants of (axis length, sigma set):
`BlurBands` keeps them as module buffers, built once per axis length and
moved with the module. The pads' source indices and the convolutions' taps
are built once per device (`utils.constants.device_constant`), so no call
after the first copies from host memory and a captured program reads them.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from visualslam_tpu_torch.utils.constants import device_constant


def gaussian_taps(sigma: float, radius: int | None = None,
                  truncate: float = 4.0) -> np.ndarray:
    """1-D normalized Gaussian taps with radius ceil(truncate*sigma)."""
    if radius is None:
        radius = max(1, int(math.ceil(truncate * float(sigma))))
    x = np.arange(-radius, radius + 1, dtype=np.float64)
    k = np.exp(-0.5 * (x / max(float(sigma), 1e-12)) ** 2)
    k /= k.sum()
    return k.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _band_matrices(n: int, taps_key: tuple, R: int) -> np.ndarray:
    """[S, n + 2R, n] banded Toeplitz matrices: column j holds kernel s
    centered at padded row j + R. Cached per (axis length, kernel set)."""
    taps_list = [np.asarray(t, np.float32) for t in taps_key]
    T = np.zeros((len(taps_list), n + 2 * R, n), np.float32)
    for s_i, t in enumerate(taps_list):
        r = (len(t) - 1) // 2
        for j in range(n):
            T[s_i, j + R - r: j + R + r + 1, j] = t
    return T


def taps_key(sigmas: Sequence[float], truncate: float = 4.0) -> tuple:
    """Hashable per-sigma tap lists (the `_band_matrices` cache key)."""
    return tuple(tuple(gaussian_taps(float(s), truncate=truncate).tolist())
                 for s in sigmas)


@functools.lru_cache(maxsize=64)
def _pad_index(n: int, r: int, mode: str) -> np.ndarray:
    """Source index of each position of an axis padded by r on both sides
    in numpy's `mode` ("symmetric": the edge sample repeats; "edge")."""
    return np.pad(np.arange(n), r, mode=mode)


def pad_axis(x: torch.Tensor, dim: int, r: int,
             mode: str = "symmetric") -> torch.Tensor:
    n = x.shape[dim]
    idx = device_constant(("pad", n, r, mode), x.device,
                          lambda: _pad_index(n, r, mode))
    return x.index_select(dim, idx)


def pad_symmetric(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    return pad_axis(x, dim, r, "symmetric")


def _pad2d(img: torch.Tensor, ry: int, rx: int, mode: str) -> torch.Tensor:
    return pad_axis(pad_axis(img, -2, ry, mode), -1, rx, mode)


def taps_table(key: tuple, radius: int) -> np.ndarray:
    """[S, 2R + 1] float32: each sigma's taps centred and zero-padded to the
    largest radius (the table `pallas_blur_stack` builds)."""
    T = np.zeros((len(key), 2 * radius + 1), np.float32)
    for s_i, t in enumerate(key):
        r = (len(t) - 1) // 2
        T[s_i, radius - r: radius + r + 1] = t
    return T


class BlurBands(nn.Module):
    """The blur constants of one sigma set, as non-persistent buffers built
    on first use: the band matrices `band_<n>`, one per axis length n
    (blur_mode="matmul"), and the tap table `tap_table` (blur_mode="pallas")."""

    def __init__(self, sigmas: Sequence[float], truncate: float = 4.0):
        super().__init__()
        self.sigmas = tuple(float(s) for s in sigmas)
        self.key = taps_key(self.sigmas, truncate)
        self.radius = max((len(t) - 1) // 2 for t in self.key)

    def _buffer(self, name: str, device, make) -> torch.Tensor:
        t = self._buffers.get(name)
        if t is None or t.device != torch.device(device):
            self.register_buffer(name, torch.from_numpy(make()).to(device),
                                 persistent=False)
        return self._buffers[name]

    def get(self, n: int, device: torch.device) -> torch.Tensor:
        """[S, n + 2R, n] float32 band matrices on `device`."""
        return self._buffer(f"band_{n}", device,
                            lambda: _band_matrices(n, self.key, self.radius))

    def taps(self, device: torch.device) -> torch.Tensor:
        """[S, 2R + 1] float32 tap table on `device`."""
        return self._buffer("tap_table", device,
                            lambda: taps_table(self.key, self.radius))


def blur_stack_matmul(img: torch.Tensor, bands: BlurBands) -> torch.Tensor:
    """Blur [B, H, W] float32 frames to the S sigmas of `bands` ->
    [B, S, H, W]."""
    B, H, W = img.shape
    R = bands.radius
    Tx = bands.get(W, img.device)                          # [S, W+2R, W]
    Ty = bands.get(H, img.device)                          # [S, H+2R, H]
    S = Tx.shape[0]
    xp = pad_symmetric(img, 2, R).reshape(B * H, W + 2 * R)
    # x pass as ONE product against the S band matrices side by side (a
    # broadcast matmul would copy the [S, W+2R, W] bands once per frame)
    hx = xp @ Tx.permute(1, 0, 2).reshape(W + 2 * R, S * W)
    hx = hx.reshape(B, H, S, W).permute(0, 2, 1, 3)        # [B, S, H, W]
    yp = pad_symmetric(hx, 2, R)                           # [B, S, H+2R, W]
    return torch.matmul(Ty.transpose(1, 2), yp)            # [B, S, H, W]


def _separable(x: torch.Tensor, kh: torch.Tensor, kv: torch.Tensor,
               groups: int = 1) -> torch.Tensor:
    """A horizontal then a vertical VALID correlation of [N, 1, H', W']:
    kh [C, 1, 1, K] maps 1 -> C channels, kv [C, 1, K, 1] is depthwise."""
    return F.conv2d(F.conv2d(x, kh), kv, groups=groups)


def blur_stack(img: torch.Tensor, sigmas: Sequence[float],
               truncate: float = 4.0, mode: str = "symmetric") -> torch.Tensor:
    """Blur [B, H, W] frames with S sigmas at once -> [B, S, H, W]
    (blur_mode="conv"): the kernels zero-padded to the largest radius, an
    x pass of 1 -> S channels, then a depthwise y pass."""
    key = taps_key(sigmas, truncate)
    R = max((len(t) - 1) // 2 for t in key)
    S, K = len(key), 2 * R + 1
    taps = device_constant(("taps_table", key, R), img.device,
                           lambda: taps_table(key, R))
    x = _pad2d(img, R, R, mode)[:, None]                 # [B, 1, H+2R, W+2R]
    return _separable(x, taps.view(S, 1, 1, K), taps.view(S, 1, K, 1), S)


def gaussian_blur(img: torch.Tensor, sigma: float, truncate: float = 4.0,
                  mode: str = "symmetric") -> torch.Tensor:
    """Separable Gaussian blur of [..., H, W] with one sigma."""
    taps = device_constant(
        ("taps", float(sigma), float(truncate)), img.device,
        lambda: gaussian_taps(sigma, truncate=truncate))
    K = taps.shape[0]
    r = (K - 1) // 2
    lead, (H, W) = img.shape[:-2], img.shape[-2:]
    x = _pad2d(img, r, r, mode).reshape(-1, 1, H + 2 * r, W + 2 * r)
    return _separable(x, taps.view(1, 1, 1, K),
                      taps.view(1, 1, K, 1)).reshape(lead + (H, W))


def incremental_blur_stack(img: torch.Tensor, sigmas: Sequence[float],
                           truncate: float = 4.0,
                           mode: str = "symmetric") -> torch.Tensor:
    """[B, H, W] -> [B, S, H, W] by chained blurs (blur_mode="incremental"):
    level 0 at sigmas[0], each next one from the previous level at the
    incremental sigma sqrt(s_l^2 - s_{l-1}^2)."""
    sigmas = [float(s) for s in sigmas]
    levels = [gaussian_blur(img, sigmas[0], truncate, mode)]
    for prev, cur in zip(sigmas[:-1], sigmas[1:]):
        inc = math.sqrt(max(cur * cur - prev * prev, 1e-12))
        levels.append(gaussian_blur(levels[-1], inc, truncate, mode))
    return torch.stack(levels, dim=1)


def box_filter(img: torch.Tensor, window: int) -> torch.Tensor:
    """Sum (not mean) over a window x window box of [..., H, W], same size,
    edge-replicated: the x pass, then the y pass, each adding the window's
    values in order, the same bits on every device. At window 3 (the
    Harris windows) that is the order XLA's convolution with ones sums in;
    wider windows XLA sums in another order."""
    r = window // 2
    H, W = img.shape[-2:]
    x = _pad2d(img, r, r, "edge")
    sx = x[..., :, 0:W]
    for i in range(1, window):
        sx = sx + x[..., :, i:i + W]
    out = sx[..., 0:H, :]
    for i in range(1, window):
        out = out + sx[..., i:i + H, :]
    return out

"""Multi-sigma Gaussian blur as banded-Toeplitz matrix products
(visualslam_tpu/ops/blur.py, `blur_mode="matmul"`), and the blur's
constants. `blur_mode="pallas"` runs the separable-convolution kernel of
ops/cuda/blur.py on the tap table `BlurBands.taps` holds.

One image blurred to S sigmas at once: a symmetric-padded x pass and a
symmetric-padded y pass, each one dense product against [S, n + 2R, n]
band matrices whose column j holds sigma s's taps centred on padded row
j + R. The JAX package runs both products outside any Pallas kernel, so
here they are plain `torch.matmul` calls; in float32 with TF32 off
(frontend.detect_and_describe) they agree with the JAX package to float32
rounding. The band matrices are constants of (axis length, sigma set):
`BlurBands` keeps them as module buffers, built once per axis length and
moved with the module.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import numpy as np
import torch
from torch import nn


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
def _symmetric_index(n: int, r: int) -> np.ndarray:
    """Source index of each position of an axis padded by r on both sides
    in numpy's "symmetric" mode (the edge sample repeats)."""
    return np.pad(np.arange(n), r, mode="symmetric")


def pad_symmetric(x: torch.Tensor, dim: int, r: int) -> torch.Tensor:
    idx = torch.from_numpy(_symmetric_index(x.shape[dim], r)).to(x.device)
    return x.index_select(dim, idx)


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

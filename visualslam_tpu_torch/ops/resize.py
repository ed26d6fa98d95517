"""Resize ops for pyramid construction (visualslam_tpu/ops/resize.py).

`resize_linear` is `jax.image.resize(..., method="linear")` (antialias on,
its default): per axis a dense [n_in, n_out] weight matrix, built in numpy
as `jax._src.image.scale.compute_weight_mat` builds it (triangle kernel,
sample position (i + 0.5) / scale - 0.5, kernel widened by 1 / scale when
downscaling, columns renormalised, columns whose sample lies outside the
input zeroed), applied as two float32 products (TF32 off,
frontend.detect_and_describe). The JAX package contracts both in one
einsum; the products' rounding differs by an ulp or two. `F.interpolate`
is another filter (no kernel widening; with antialias, PIL's support and
normalisation) and is not used. `ResizeWeights` keeps the matrices as
module buffers, built once per (n_in, n_out) and moved with the module.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn


@functools.lru_cache(maxsize=64)
def weight_matrix(n_in: int, n_out: int) -> np.ndarray:
    """[n_in, n_out] float32 linear-resize weights, antialiased, rounded as
    XLA's CPU backend rounds jax.image.resize's: the sample position as one
    fused multiply-add (float64 here, exact, then one rounding) and the
    division by the kernel scale as a product with its float32
    reciprocal."""
    f32 = np.float32
    inv_scale = f32(1.0 / (n_out / n_in))
    kernel_scale = max(inv_scale, f32(1.0))
    centres = np.arange(n_out, dtype=f32) + f32(0.5)
    sample_f = (centres.astype(np.float64) * np.float64(inv_scale)
                - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(n_in, dtype=f32)[:, None]) \
        * (f32(1.0) / kernel_scale)
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x))
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= n_in - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


class ResizeWeights(nn.Module):
    """Linear-resize weight matrices as non-persistent buffers
    `w_<n_in>_<n_out>`, built on first use."""

    def get(self, n_in: int, n_out: int, device) -> torch.Tensor:
        name = f"w_{n_in}_{n_out}"
        t = self._buffers.get(name)
        if t is None or t.device != torch.device(device):
            self.register_buffer(
                name, torch.from_numpy(weight_matrix(n_in, n_out)).to(device),
                persistent=False)
        return self._buffers[name]


def resize_linear(img: torch.Tensor, h: int, w: int,
                  weights: ResizeWeights | None = None) -> torch.Tensor:
    """[..., H, W] float32 -> [..., h, w], jax.image.resize's "linear".
    An axis whose length does not change is left as it is."""
    weights = ResizeWeights() if weights is None else weights
    H, W = img.shape[-2:]
    out = img
    if w != W:
        out = out @ weights.get(W, w, img.device)
    if h != H:
        out = weights.get(H, h, img.device).T @ out
    return out


def upsample2x_linear(img: torch.Tensor,
                      weights: ResizeWeights | None = None) -> torch.Tensor:
    """2x linear upsample of [..., H, W] (half-pixel centres)."""
    H, W = img.shape[-2:]
    return resize_linear(img, 2 * H, 2 * W, weights)


def downsample2x_nearest(img: torch.Tensor) -> torch.Tensor:
    """0.5x nearest downsample of [..., H, W]: every second pixel."""
    return img[..., ::2, ::2]

"""Circular soft histograms and orientation peaks
(visualslam_tpu/ops/histograms.py).

`soft_histogram` is the dense triangle-kernel formulation (each sample split
linearly between its two nearest circular bins); the descriptor kernels'
plain versions build on it. `histogram_peaks` finds the orientation peaks
with parabolic refinement; its top-k keeps the lower bin first on ties, as
jax.lax.top_k does.
"""

from __future__ import annotations

import torch

from visualslam_tpu_torch.utils.masked import top_k


def mod(a: torch.Tensor, n: float) -> torch.Tensor:
    """jnp.mod for a positive divisor: the truncated remainder moved into
    [0, n). torch.remainder rounds differently (a - floor(a/n)*n)."""
    r = torch.fmod(a, n)
    return torch.where(r < 0, r + n, r)


def soft_histogram(values: torch.Tensor, weights: torch.Tensor,
                   num_bins: int, period: float,
                   compute_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Weighted circular histogram over the last axis: values [..., P] in
    [0, period), weights [..., P] -> [..., num_bins] float32. With
    compute_dtype (bfloat16) the triangle weights and the weights are
    rounded to it, and the products and sums stay float32."""
    pos = values * (num_bins / period)                      # [..., P]
    centers = torch.arange(num_bins, dtype=pos.dtype, device=pos.device) + 0.5
    d = pos[..., None] - centers                            # [..., P, B]
    d = mod(d + num_bins / 2.0, num_bins) - num_bins / 2.0
    tri = (1.0 - d.abs()).clamp_min(0.0)
    if compute_dtype is not None:
        tri = tri.to(compute_dtype).float()
        weights = weights.to(compute_dtype).float()
    return torch.einsum("...pb,...p->...b", tri, weights)


def histogram_peaks(hist: torch.Tensor, num_peaks: int, peak_ratio: float,
                    period: float):
    """Up to num_peaks circular-local maxima above peak_ratio * max.

    hist: [..., B]. Returns (angles [..., num_peaks] in [0, period),
    peak_values [..., num_peaks], valid [..., num_peaks])."""
    B = hist.shape[-1]
    left = torch.roll(hist, 1, dims=-1)
    right = torch.roll(hist, -1, dims=-1)
    is_peak = (hist > left) & (hist >= right)
    gmax = hist.amax(dim=-1, keepdim=True)
    qualifies = is_peak & (hist >= peak_ratio * gmax) & (gmax > 0)
    scores = torch.where(qualifies, hist, torch.full_like(hist, float("-inf")))
    top_vals, top_bins = top_k(scores, num_peaks)
    valid = torch.isfinite(top_vals)
    top_bins = torch.where(valid, top_bins, torch.zeros_like(top_bins))
    h_c = hist.gather(-1, top_bins)
    h_l = left.gather(-1, top_bins)
    h_r = right.gather(-1, top_bins)
    denom = h_l - 2.0 * h_c + h_r
    safe = torch.where(denom == 0, torch.ones_like(denom), denom)
    delta = torch.where(denom.abs() > 1e-12, 0.5 * (h_l - h_r) / safe,
                        torch.zeros_like(denom)).clamp(-0.5, 0.5)
    angles = mod((top_bins.to(hist.dtype) + 0.5 + delta) * (period / B),
                 period)
    return angles, torch.where(valid, top_vals, torch.zeros_like(top_vals)), valid


def gaussian_window(size: int, sigma: torch.Tensor) -> torch.Tensor:
    """[..., size, size] Gaussian weights centred on the window centre
    ((size - 1) / 2) for a batch of sigmas [...] (float32)."""
    offs = (torch.arange(size, dtype=torch.float32, device=sigma.device)
            - (size - 1) / 2.0)
    r2 = offs[:, None] ** 2 + offs[None, :] ** 2
    return torch.exp(-r2 / (2.0 * sigma[..., None, None] ** 2))

"""Per-keypoint patch crops and sampling inside them
(visualslam_tpu/ops/patches.py).

`crop_patches` cuts one [C, Ph, Pw] window per keypoint out of a level stack
with the JAX package's exact origins: rows about the rounded centre, clamped
into the level; columns from a 64-aligned origin, 128 wide, edge-replicated
past the level's right border, or the full row where the level is narrower
than 128. It is `patch_origins` (where a patch starts) followed by
`gather_patches` (the cut at given origins). The plain versions of the
orientation / descriptor kernels read these patches; the kernels read the
levels in place at the same origins. `tent_sample_patches` and
`rotated_grid` are the plain bilinear-sampling formulation the plain
versions use.
"""

from __future__ import annotations

import math

import torch

_SEG = 64       # column origins are multiples of this; patches are 2 wide


def patch_shape(H: int, W: int, patch: int) -> tuple:
    """(Ph, Pw) of the patches cut from an H x W level: Ph = min(patch, H),
    Pw = 128 (W >= 128) or W (the full row)."""
    return min(patch, H), (2 * _SEG if W >= 2 * _SEG else W)


def patch_origins(H: int, W: int, center_yx: torch.Tensor, patch: int):
    """The JAX package's patch origins for centres [..., 2] (float) in an
    H x W level: (y0, x0) int32 [...]. Rows about the rounded centre,
    clamped into the level; columns from a 64-aligned origin such that the
    128-wide window holds the patch (0 where W < 128)."""
    ph, _ = patch_shape(H, W, patch)
    cy = torch.round(center_yx[..., 0]).to(torch.int64)
    y0 = (cy - ph // 2).clamp(0, H - ph)
    if W < 2 * _SEG:
        x0 = torch.zeros_like(y0)
    else:
        if patch > _SEG + 1:
            raise ValueError(
                f"patch {patch} can escape the two-segment window "
                f"(max {_SEG + 1})")
        nseg = -(-W // _SEG)
        cx = torch.round(center_yx[..., 1]).to(torch.int64)
        x0d = (cx - patch // 2).clamp(0, W - min(patch, W))
        x0 = torch.minimum(x0d // _SEG,
                           torch.full_like(x0d, nseg - 2)) * _SEG
    return y0.to(torch.int32), x0.to(torch.int32)


def gather_patches(stack: torch.Tensor, frame: torch.Tensor,
                   level_idx: torch.Tensor, y0: torch.Tensor,
                   x0: torch.Tensor, patch: int) -> torch.Tensor:
    """Patches at given origins from a channel-first level stack.

    stack: [B, C, L, H, W]; frame, level_idx, y0, x0: index tensors of one
    shape S, the origins as `patch_origins` gives them. Returns
    [*S, C, Ph, Pw] in stack's dtype; columns past the level's right
    border repeat its last column."""
    B, C, L, H, W = stack.shape
    ph, pw = patch_shape(H, W, patch)
    src = stack
    if W >= 2 * _SEG:
        nseg = -(-W // _SEG)
        if nseg * _SEG != W:   # edge-replicate the right border
            src = torch.cat([stack, stack[..., -1:].expand(
                B, C, L, H, nseg * _SEG - W)], dim=-1)
    src = src.contiguous()
    # overlapping strided view: win[b, c, l, y, s, i, j] =
    # src[b, c, l, y + i, s * 64 + j]; indexing it with index tensors
    # gathers whole windows without a per-element index tensor
    sb, sc, sl, sh, _ = src.stride()
    idx = (frame.long(), slice(None), level_idx.long(), y0.long())
    if W < 2 * _SEG:
        win = src.as_strided((B, C, L, H - ph + 1, ph, pw),
                             (sb, sc, sl, sh, sh, 1))
        return win[idx]
    win = src.as_strided((B, C, L, H - ph + 1, nseg - 1, ph, pw),
                         (sb, sc, sl, sh, _SEG, sh, 1))
    return win[idx + (x0.long() // _SEG,)]


def crop_patches(stack: torch.Tensor, level_idx: torch.Tensor,
                 center_yx: torch.Tensor, patch: int):
    """One patch per keypoint from a channel-first level stack.

    stack: [B, C, L, H, W]; level_idx: [B, K]; center_yx: [B, K, 2] float.
    Returns (patches [B, K, C, Ph, Pw] in stack's dtype, y0 [B, K] int32,
    x0 [B, K] int32) with Ph = min(patch, H) and Pw = 128 (W >= 128) or W.
    """
    B, _, _, H, W = stack.shape
    y0, x0 = patch_origins(H, W, center_yx, patch)
    frame = torch.arange(B, device=stack.device)[:, None].expand_as(y0)
    return (gather_patches(stack, frame, level_idx, y0, x0, patch), y0, x0)


def tent_sample_patches(patches: torch.Tensor, y0: torch.Tensor,
                        x0: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples inside pre-cropped patches as two tent-weight
    products (each tent row holds the two bilinear weights of a sample;
    integer coordinates reduce to exact one-hots).

    patches: [K, C, Ph, Pw] with origins y0, x0 [K]; coords: [K, ..., 2]
    absolute (y, x), clamped into the patch. bf16 patches take bf16-rounded
    y weights, as the descriptor kernels do; the products accumulate in
    float32. Returns [K, ..., C] float32."""
    K, C, ph, pw = patches.shape
    shape = coords.shape[1:-1]
    py = (coords[..., 0].reshape(K, -1)
          - y0[:, None].to(coords.dtype)).clamp(0.0, ph - 1.0)
    px = (coords[..., 1].reshape(K, -1)
          - x0[:, None].to(coords.dtype)).clamp(0.0, pw - 1.0)
    taps_y = torch.arange(ph, dtype=coords.dtype, device=coords.device)
    taps_x = torch.arange(pw, dtype=coords.dtype, device=coords.device)
    wy = (1.0 - (py[..., None] - taps_y).abs()).clamp_min(0.0)   # [K, N, Ph]
    wx = (1.0 - (px[..., None] - taps_x).abs()).clamp_min(0.0)   # [K, N, Pw]
    if patches.dtype == torch.bfloat16:
        wy = wy.to(torch.bfloat16).float()
    t = torch.einsum("kni,kcij->kcnj", wy, patches.float())
    out = torch.einsum("kcnj,knj->knc", t, wx)
    return out.reshape((K,) + shape + (C,))


def rotated_grid(yx: torch.Tensor, angle_deg: torch.Tensor,
                 size: int) -> torch.Tensor:
    """Sampling coordinates of a size x size grid (unit spacing) rotated by
    angle about yx. yx: [K, 2]; angle_deg: [K]. Returns [K, size, size, 2]
    (y, x)."""
    theta = angle_deg * (math.pi / 180.0)
    c, s = torch.cos(theta), torch.sin(theta)
    offs = (torch.arange(size, dtype=torch.float32, device=yx.device)
            - (size - 1) / 2.0)
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    rx = c[:, None, None] * gx - s[:, None, None] * gy
    ry = s[:, None, None] * gx + c[:, None, None] * gy
    return torch.stack([ry, rx], dim=-1) + yx[:, None, None, :]

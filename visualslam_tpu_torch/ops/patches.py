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

The rest of the module is the JAX package's per-image window and sampling
functions with a leading frame axis (each the JAX function vmapped over
frames): `extract_patches` (clamped integer windows), `sample_bilinear`,
`sample_bilinear_stack`, `sample_bilinear_patches` (crop + tent sampling),
`crop_windows`, `extract_rotated_patches`, `rotate_image` and
`rotate_points`.
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


def rotated_grid(yx: torch.Tensor, angle_deg: torch.Tensor, size: int,
                 step: torch.Tensor | float = 1.0) -> torch.Tensor:
    """Sampling coordinates of a size x size grid rotated by angle about yx.
    yx: [..., 2]; angle_deg: [...]; step: scalar or [...] spacing in pixels
    (scaling is skipped at the unit step, which changes no bit). Returns
    [..., size, size, 2] (y, x)."""
    theta = angle_deg * (math.pi / 180.0)
    c, s = torch.cos(theta)[..., None, None], torch.sin(theta)[..., None, None]
    offs = (torch.arange(size, dtype=torch.float32, device=yx.device)
            - (size - 1) / 2.0)
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    rx = c * gx - s * gy
    ry = s * gx + c * gy
    coords = torch.stack([ry, rx], dim=-1)
    if not (isinstance(step, float) and step == 1.0):
        step = _on(yx, step)
        coords = coords * step.expand(theta.shape)[..., None, None, None]
    return coords + yx[..., None, None, :]


def _channels_first(stack: torch.Tensor, channels: bool) -> torch.Tensor:
    """[B, L, H, W] or channels-last [B, L, H, W, C] -> [B, C, L, H, W]."""
    return stack.permute(0, 4, 1, 2, 3) if channels else stack[:, None]


def _rows(t: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """t[b, idx[b, ...]] for t [B, N, ...] and idx [B, ...]."""
    b = torch.arange(t.shape[0], device=t.device).view(
        (-1,) + (1,) * (idx.ndim - 1))
    return t[b, idx]


def extract_patches(img: torch.Tensor, yx: torch.Tensor, size: int,
                    level_idx: torch.Tensor | None = None) -> torch.Tensor:
    """Windows [B, K, size, size(, C)] centred at round(yx) (half to even),
    clamped inside the image. img: [B, H, W] or [B, L, H, W] with
    level_idx [B, K], optionally with a trailing channel axis; yx [B, K, 2]."""
    channels = img.ndim - (3 if level_idx is None else 4)
    H, W = img.shape[img.ndim - channels - 2: img.ndim - channels]
    r = size // 2
    y0 = (torch.round(yx[..., 0]).long() - r).clamp(0, H - size)
    x0 = (torch.round(yx[..., 1]).long() - r).clamp(0, W - size)
    base = y0 * W + x0
    if level_idx is not None:
        base = base + level_idx.long() * (H * W)
    d = torch.arange(size, device=yx.device)
    idx = base[..., None, None] + (d[:, None] * W + d[None, :])  # [B,K,S,S]
    flat = img.reshape((img.shape[0], -1) + img.shape[img.ndim - channels:])
    return _rows(flat, idx)


def _bilinear(flat: torch.Tensor, coords: torch.Tensor, H: int, W: int,
              row_off, channels: bool) -> torch.Tensor:
    """Edge-clamped bilinear samples of flat [B, R, W(, C)] (R = L * H rows,
    a level's rows starting at row_off) at coords [B, ..., 2]."""
    y = coords[..., 0].clamp(0.0, H - 1.0)
    x = coords[..., 1].clamp(0.0, W - 1.0)
    y0 = torch.floor(y).long()
    x0 = torch.floor(x).long()
    y1 = (y0 + 1).clamp(max=H - 1)
    x1 = (x0 + 1).clamp(max=W - 1)
    wy = y - y0.to(y.dtype)
    wx = x - x0.to(x.dtype)
    y0, y1 = y0 + row_off, y1 + row_off
    rows = flat.reshape((flat.shape[0], -1) + flat.shape[3:])  # [B, R*W(,C)]
    v00, v01, v10, v11 = (_rows(rows, yy * W + xx) for yy, xx in
                          ((y0, x0), (y0, x1), (y1, x0), (y1, x1)))
    if channels:
        wy, wx = wy[..., None], wx[..., None]
    return ((1 - wy) * (1 - wx) * v00 + (1 - wy) * wx * v01
            + wy * (1 - wx) * v10 + wy * wx * v11)


def sample_bilinear(img: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of img [B, H, W] at float coords [B, ..., 2] (y, x),
    edge-clamped -> [B, ...]."""
    _, H, W = img.shape
    return _bilinear(img, coords, H, W, 0, False)


def sample_bilinear_stack(stack: torch.Tensor, level_idx: torch.Tensor,
                          coords: torch.Tensor) -> torch.Tensor:
    """Bilinear samples of stack [B, L, H, W(, C)] at per-item levels
    level_idx [B, K] and coords [B, K, ..., 2], clamped inside the level
    -> [B, K, ...(, C)]."""
    B, L, H, W = stack.shape[:4]
    flat = stack.reshape((B, L * H, W) + stack.shape[4:])
    off = (level_idx.long() * H).view(level_idx.shape
                                      + (1,) * (coords.ndim - 3))
    return _bilinear(flat, coords, H, W, off, stack.ndim == 5)


def sample_bilinear_patches(stack: torch.Tensor, level_idx: torch.Tensor,
                            center_yx: torch.Tensor, coords: torch.Tensor,
                            patch: int) -> torch.Tensor:
    """sample_bilinear_stack's samples through one [patch, patch] crop per
    keypoint (crop_patches) and tent sampling inside it. stack [B, L, H,
    W(, C)]; level_idx [B, K]; center_yx [B, K, 2]; coords [B, K, ..., 2],
    each within patch / 2 - 1 px of its centre -> [B, K, ...(, C)]."""
    channels = stack.ndim == 5
    patches, y0, x0 = crop_patches(_channels_first(stack, channels),
                                   level_idx, center_yx, patch)
    B, K = level_idx.shape
    out = tent_sample_patches(patches.flatten(0, 1), y0.flatten(),
                              x0.flatten(), coords.flatten(0, 1))
    out = out.reshape((B, K) + out.shape[1:])
    return out if channels else out[..., 0]


def crop_windows(stack: torch.Tensor, level_idx: torch.Tensor,
                 center_yx: torch.Tensor, size: int) -> torch.Tensor:
    """extract_patches' integer windows [B, K, size, size(, C)] through
    the segment crop and exact tent selection."""
    offs = torch.arange(size, dtype=torch.float32,
                        device=center_yx.device) - size // 2
    gy, gx = torch.meshgrid(offs, offs, indexing="ij")
    grid = torch.stack([gy, gx], dim=-1)
    ctr = torch.round(center_yx).float()
    return sample_bilinear_patches(stack, level_idx, center_yx,
                                   ctr[..., None, None, :] + grid, size)


def extract_rotated_patches(img: torch.Tensor, yx: torch.Tensor,
                            angle_deg: torch.Tensor, size: int,
                            step: torch.Tensor | float = 1.0) -> torch.Tensor:
    """[B, K, size, size] rotation-normalised windows, bilinearly sampled
    from img [B, H, W] (yx [B, K, 2], angle_deg [B, K])."""
    return sample_bilinear(img, rotated_grid(yx, angle_deg, size, step))


def _on(like: torch.Tensor, value) -> torch.Tensor:
    """value as float32 on like's device: a tensor cast there, a number or
    a tuple of numbers by device fills (no copy from host memory), an
    array of host data copied."""
    if torch.is_tensor(value):
        return value.to(device=like.device, dtype=torch.float32)
    if isinstance(value, (tuple, list)):
        return torch.stack([_on(like, v) for v in value])
    if getattr(value, "ndim", 0):
        return torch.as_tensor(value, dtype=torch.float32, device=like.device)
    return torch.full((), float(value), dtype=torch.float32,
                      device=like.device)


def rotate_points(yx: torch.Tensor, angle_deg, center,
                  clockwise: bool = False) -> torch.Tensor:
    """Rotate points [..., 2] (y, x) about a centre by angle_deg degrees,
    counter-clockwise in image coordinates (y down) unless clockwise."""
    theta = _on(yx, angle_deg) * (math.pi / 180.0)
    if clockwise:
        theta = -theta
    c, s = torch.cos(theta), torch.sin(theta)
    center = _on(yx, center)
    d = yx - center
    ry = s * d[..., 1] + c * d[..., 0]
    rx = c * d[..., 1] - s * d[..., 0]
    return torch.stack([ry, rx], dim=-1) + center


def rotate_image(img: torch.Tensor, angle_deg, center=None) -> torch.Tensor:
    """Frames [B, H, W] rotated counter-clockwise about a centre (default the
    image centre), bilinear, same shape, out-of-frame samples clamped to
    the edge."""
    B, H, W = img.shape
    if center is None:
        center = ((H - 1) / 2.0, (W - 1) / 2.0)
    yy, xx = torch.meshgrid(
        torch.arange(H, dtype=torch.float32, device=img.device),
        torch.arange(W, dtype=torch.float32, device=img.device),
        indexing="ij")
    # inverse mapping: sample the source at the point that rotates to (y, x)
    src = rotate_points(torch.stack([yy, xx], dim=-1), angle_deg, center,
                        clockwise=True)
    return sample_bilinear(img, src.expand(B, H, W, 2))

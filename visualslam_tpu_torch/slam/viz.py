"""Visualization: keypoint/match overlays rendered to image files
(visualslam_tpu/slam/viz.py); they take the port's Features / Matches, on
any device.

The reference's observability tool is cv::imshow windows plus DrawKeypoint /
DrawBoundingBox overlays (Diff_of_Gauss.cpp:135-214, 868-873;
Harris_corners.cpp:132-144). Headless equivalent: render the same overlays
(scaled circle + orientation tick per keypoint, match lines) into PNGs with
PIL — no GUI dependency.
"""

from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def _to_rgb(img: np.ndarray) -> "object":
    from PIL import Image

    arr = (np.clip(img, 0, 1) * 255).astype(np.uint8)
    return Image.fromarray(arr).convert("RGB")


def draw_keypoints(img: np.ndarray, feats, path: str,
                   color=(255, 220, 0), max_draw: int = 2000) -> None:
    """Render detected keypoints (circle radius ~ scale, tick = orientation),
    like the reference's DrawKeypoint overlay (Diff_of_Gauss.cpp:186-214)."""
    from PIL import ImageDraw

    im = _to_rgb(img)
    d = ImageDraw.Draw(im)
    kps = feats.keypoints
    v = _np(kps.valid)
    yx = _np(kps.yx)[v][:max_draw]
    sig = _np(kps.sigma)[v][:max_draw]
    ang = np.deg2rad(_np(kps.orientation)[v][:max_draw])
    for (y, x), s, a in zip(yx, sig, ang):
        r = max(2.0, 3.0 * s)
        d.ellipse([x - r, y - r, x + r, y + r], outline=color)
        d.line([x, y, x + r * np.cos(a), y + r * np.sin(a)], fill=color)
    im.save(path)


def draw_matches(img_a: np.ndarray, img_b: np.ndarray, feats_a, feats_b,
                 matches, path: str, max_draw: int = 300) -> None:
    """Side-by-side match visualization."""
    from PIL import Image, ImageDraw

    A = _to_rgb(img_a)
    B = _to_rgb(img_b)
    H = max(A.height, B.height)
    canvas = Image.new("RGB", (A.width + B.width, H))
    canvas.paste(A, (0, 0))
    canvas.paste(B, (A.width, 0))
    d = ImageDraw.Draw(canvas)
    v = _np(matches.valid)
    ia = _np(matches.idx_a)[v][:max_draw]
    ib = _np(matches.idx_b)[v][:max_draw]
    ya = _np(feats_a.keypoints.yx)[ia]
    yb = _np(feats_b.keypoints.yx)[ib]
    for (y1, x1), (y2, x2) in zip(ya, yb):
        d.line([x1, y1, x2 + A.width, y2], fill=(0, 255, 120))
    canvas.save(path)


def save_pyramid_montage(scale_space, path: str, octave: int | None = None,
                         max_w: int = 1600, frame: int = 0) -> None:
    """Render frame `frame`'s Gaussian stack(s) of a batched ScaleSpace as
    an image-grid PNG — the headless analogue of the reference's
    showOctave/showPyramid windows (GaussPyramid.cpp:45-63). One row per
    octave (or a single octave)."""
    from PIL import Image

    octs = ([octave] if octave is not None
            else list(range(len(scale_space.gauss))))
    rows = []
    for o in octs:
        stack = _np(scale_space.gauss[o][frame])
        row = np.concatenate(list(stack), axis=1)
        rows.append(row)
    W = max(r.shape[1] for r in rows)
    H = sum(r.shape[0] for r in rows)
    canvas = np.zeros((H, W), np.float32)
    y = 0
    for r in rows:
        canvas[y: y + r.shape[0], : r.shape[1]] = r
        y += r.shape[0]
    img = Image.fromarray((np.clip(canvas, 0, 1) * 255).astype(np.uint8))
    if img.width > max_w:
        img = img.resize((max_w, int(img.height * max_w / img.width)))
    img.save(path)


def draw_trajectory(poses: np.ndarray, path: str, gt: np.ndarray = None,
                    size: int = 640) -> None:
    """Top-down (x, z) trajectory plot rendered directly to a PNG."""
    from PIL import Image, ImageDraw

    img = Image.new("RGB", (size, size), (20, 20, 28))
    d = ImageDraw.Draw(img)
    all_pts = [poses[:, :, 3][:, [0, 2]]]
    if gt is not None:
        all_pts.append(gt[:, :, 3][:, [0, 2]])
    pts = np.concatenate(all_pts)
    lo = pts.min(0) - 1
    hi = pts.max(0) + 1
    scale = (size - 40) / max(hi - lo)

    def to_px(p):
        q = (p - lo) * scale + 20
        return q[0], size - q[1]

    if gt is not None:
        xy = [to_px(p) for p in gt[:, :, 3][:, [0, 2]]]
        d.line(xy, fill=(120, 120, 130), width=2)
    xy = [to_px(p) for p in poses[:, :, 3][:, [0, 2]]]
    d.line(xy, fill=(80, 200, 255), width=2)
    img.save(path)

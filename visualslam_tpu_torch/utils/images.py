"""Host-side image IO and padding helpers (visualslam_tpu/utils/images.py).

The reference loads images with cv::imread and pads with
cv::copyMakeBorder(BORDER_REPLICATE) (GaussPyramid.cpp:133-141,
Diff_of_Gauss.cpp:571-580). Device-side padding here is `F.pad` in
"replicate" mode; host-side loading uses PIL, imported when it is used.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def load_gray(path: str, dtype=np.float32) -> np.ndarray:
    """Load an image file as grayscale float32 in [0, 1], shape [H, W]."""
    from PIL import Image

    img = Image.open(path).convert("L")
    return np.asarray(img, dtype=dtype) / 255.0


def replicate_pad(img: torch.Tensor, pad: int) -> torch.Tensor:
    """Edge-replicate padding on the last two axes (ref padOctave,
    GaussPyramid.cpp:133-141)."""
    shape = img.shape
    x = img.reshape((-1, 1) + tuple(shape[-2:]))
    x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    return x.reshape(tuple(shape[:-2]) + tuple(x.shape[-2:]))


def to_device_batch(imgs, device="cuda") -> torch.Tensor:
    """Stack a list of [H, W] arrays to a [B, H, W] tensor on `device`."""
    return torch.stack([torch.as_tensor(np.asarray(i)) for i in imgs]).to(
        device)

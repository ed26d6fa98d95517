"""Float32 matmul precision on the card.

The JAX package traces its frontend and geometry at float32 matmul
precision. On the card a float32 matmul is full float32 by default, but a
float32 convolution goes through cuDNN in TF32 by default, and either
default can be changed by the caller. The port's entry points therefore
turn TF32 off for both (process-wide settings)."""

from __future__ import annotations

import torch


def f32_matmul() -> None:
    """Set torch.backends.cuda.matmul.allow_tf32 and
    torch.backends.cudnn.allow_tf32 to False."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

"""Constant tensors built on the host once per device.

A constant the frontend builds in numpy (a pad's source index, Gaussian
taps, the ORB moment weights and BRIEF pattern, the extrema cube's
offsets) reaches the card by a copy from pageable host memory: a host sync
on the eager path, and inside a CUDA graph capture an error or a pointer
the graph does not own. `device_constant` makes each one once per
(key, device) and keeps it for the life of the process, so a captured
program's eager warm-up builds what its capture then reads, and every
later call, eager or replayed, reads the same device tensor.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

_TABLE: dict = {}


def device_constant(key: tuple, device: torch.device,
                    make: Callable[[], np.ndarray]) -> torch.Tensor:
    """make()'s array on `device`, built by the first call of (key, device)
    (never to be written: every caller shares it)."""
    dev = torch.device(device)
    t = _TABLE.get((key, dev))
    if t is None:
        t = _TABLE[(key, dev)] = torch.from_numpy(make()).to(dev)
    return t

"""The device a run measures on, named as the port's results record it."""

from __future__ import annotations

import subprocess

import torch


def card_name() -> str:
    """The first card's name and power limit, as `nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader` prints them (for
    example "NVIDIA H100 80GB HBM3, 700.00 W")."""
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return smi.stdout.strip().splitlines()[0]


def require_device(device, who: str) -> torch.device:
    """torch.device(device); raises RuntimeError for a CUDA device when no
    card is visible (a run never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"{who}: no CUDA device (pass device='cpu' to run on the CPU)")
    return dev


def device_label(device) -> str:
    """card_name() for a CUDA device, else the device's own name."""
    dev = torch.device(device)
    return card_name() if dev.type == "cuda" else str(dev)

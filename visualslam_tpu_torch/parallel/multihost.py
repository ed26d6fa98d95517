"""Multi-process bootstrap (visualslam_tpu/parallel/multihost.py).

The sharded solvers run over an in-process mesh (parallel/mesh.py); the
only host-side distributed machinery is process bootstrap and checkpoint
coordination, which this module wraps:

  - `initialize()`: torch.distributed.init_process_group over TCP
    (coordinator address / world size / rank from the arguments or from
    SLAM_COORDINATOR, SLAM_NUM_PROCESSES, SLAM_PROCESS_ID), NCCL for a
    CUDA device and gloo for the CPU. A failed peer surfaces as a
    collective that errors or stalls: the failure-detection signal;
    recovery = restart from the latest checkpoint (slam/checkpoint.py).
  - `is_coordinator()`: gate for writing checkpoints / metrics once.

On a single process both are no-ops, so the calling code is the same
either way.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda") -> bool:
    """Initialize the default process group if configured; returns True if
    a multi-process group was actually started. `device` picks the
    backend: NCCL for a CUDA device, gloo for the CPU."""
    addr = coordinator_address or os.environ.get("SLAM_COORDINATOR")
    if addr is None:
        return False
    n = num_processes or int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    pid = process_id if process_id is not None else int(
        os.environ.get("SLAM_PROCESS_ID", "0"))
    if n <= 1:
        return False
    backend = "nccl" if torch.device(device).type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method="tcp://" + addr,
                            world_size=n, rank=pid)
    return True


def is_coordinator() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0

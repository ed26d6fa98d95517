"""Tracing and stage timing (visualslam_tpu/utils/profiling.py).

  - `annotate(name)`: a named range in torch.profiler traces
    (`torch.profiler.record_function`);
  - `trace(dir)`: a context that records a torch.profiler trace of the CPU
    and, where there is one, the CUDA device, written to `dir` as a Chrome
    trace (`trace.json`);
  - `StageTimer`: wall-clock time by stage, which the tracker's stages
    report into when `Tracker.timer` is set. A stage that reads back from
    the device absorbs the device time before it; a stage that only queues
    work measures the host's launch cost.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


def annotate(name: str):
    """Named range in torch.profiler traces."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace into log_dir/trace.json."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock time per stage."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        t0 = time.perf_counter()
        yield
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def summary(self) -> dict:
        return {k: {"total_s": round(v, 4),
                    "mean_ms": round(1e3 * v / max(self.counts[k], 1), 3),
                    "count": self.counts[k]}
                for k, v in sorted(self.totals.items())}

    def dump(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)

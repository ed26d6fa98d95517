"""Tracing and stage timing (visualslam_tpu/utils/profiling.py), the
port's one tracing module:

  - `span(name)`: a named stage of the program, reported into the active
    sink; with none, one shared no-op context (one global read). Every
    layer reports through it: the tracker's stages, the engine batch's
    parts, the host syncs by site, the pose graph and the CUDA-graph
    captures;
  - `sink(timer)`: makes `timer` (any object with a `stage(name)` context
    manager, such as `StageTimer`) the active sink for a block; the
    Tracker does so with `Tracker.timer` for the length of each public
    entry;
  - `trace(dir)`: a context that records a torch.profiler trace of the CPU
    and, where there is one, the CUDA device, written to `dir` as a Chrome
    trace (`trace.json`);
  - `StageTimer`: wall-clock time by stage, each stage also a
    `stage:`-prefixed range in torch.profiler's timeline. A stage that
    reads back from the device absorbs the device time before it; a stage
    that only queues work measures the host's launch cost.

No other module of the port opens a profiler range: a range without the
`stage:` prefix is mirrored onto the device's timeline, where it would
read as device activity.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch

STAGE = "stage:"

_NULL = contextlib.nullcontext()
_sink = None


def span(name: str):
    """The stage `name` in the active sink, else a shared no-op context."""
    s = _sink
    return _NULL if s is None else s.stage(name)


@contextlib.contextmanager
def sink(timer):
    """`timer` as the active sink inside the block (None: no sink); the
    previous one comes back after it."""
    global _sink
    prev, _sink = _sink, timer
    try:
        yield
    finally:
        _sink = prev


@contextlib.contextmanager
def trace(log_dir: str):
    """Record a torch.profiler trace into log_dir/trace.json (also when the
    block raises)."""
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.start()
    try:
        yield prof
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StageTimer:
    """Accumulates wall-clock time per stage."""

    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(STAGE + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
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

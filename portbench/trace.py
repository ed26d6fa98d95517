"""The traced run's measurements, taken from the benchmark's side of the
program's public entries:

- a stage timer handed to each tracker (`Tracker.timer`, whose stages the
  tracker reports into), which also marks each stage as a range in the
  profiler's timeline;
- host syncs that torch's sync debug mode reports inside each
  `process_stream` call;
- torch.profiler over a fixed slice of stream batches of the window's
  first drive: the device's activity, the kernels, and the host's stage
  during each idle gap;
- the host clock around each global BA, which ends in a sync;
- CUDA events around the tracker's frontend on 16 of the window's frames,
  replayed after the window.

`record()` is what the per-layer metrics' readers read.
"""

from __future__ import annotations

import contextlib
import time
import warnings
from collections import defaultdict

import torch

from portbench import roofline, stats
from portbench.drive import Hooks

STAGE = "stage:"


class StageTimer:
    """Host seconds by stage (the tracker's `timer` interface)."""

    def __init__(self, totals, counts):
        self.totals, self.counts = totals, counts

    @contextlib.contextmanager
    def stage(self, name: str):
        with torch.profiler.record_function(STAGE + name):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                self.totals[name] += time.perf_counter() - t0
                self.counts[name] += 1


def count_syncs(call):
    """(call's result, host syncs torch reports while it runs)."""
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = call()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return out, sum("called a synchronizing" in str(w.message)
                    for w in caught)


def _device_events(events) -> list:
    """[(name, start_s, end_s)] of the device's activity in a profile's
    events (the host's ranges mirrored on the device's timeline are not
    the device's activity)."""
    out = []
    for e in events:
        if (getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA
                and not e.name.startswith(STAGE)):
            out.append((e.name, e.time_range.start * 1e-6,
                        e.time_range.end * 1e-6))
    return out


def _host_ranges(events, prefix: str) -> list:
    out = []
    for e in events:
        if (getattr(e, "device_type", None) == torch.autograd.DeviceType.CPU
                and e.name.startswith(prefix)):
            out.append((e.name[len(prefix):], e.time_range.start * 1e-6,
                        e.time_range.end * 1e-6))
    return out


class TraceHooks(Hooks):
    """The traced run's hooks (drive.run_window)."""

    def __init__(self, traffic, cfg_dict: dict, cuda: bool = True):
        self.traffic = traffic
        self.cuda = cuda
        self.cfg = cfg_dict
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.syncs = []
        self.gba_s = []
        self.slice_kps = []        # per slice batch: (features, kps/octave)
        self.prof = None            # the slice's profile, read after
        first = traffic.profile_batch
        self.slice = range(first, first + traffic.profile_batches)

    def tracker(self, tracker) -> None:
        tracker.timer = StageTimer(self.totals, self.counts)

    def prepare(self) -> None:
        """Start and stop the profiler once in set-up: its first start
        initializes the device's tracing."""
        self._start()
        self._stop()
        self.prof = None

    def _start(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            torch.cuda.synchronize()
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self._range = torch.profiler.record_function(STAGE + "slice")
        self._range.__enter__()

    def _stop(self):
        if self.cuda:
            torch.cuda.synchronize()
        self._range.__exit__(None, None, None)
        self.prof.stop()

    def stream(self, call, drive: int, index: int):
        profiled = drive == 0 and index in self.slice
        if profiled and index == self.slice.start:
            self._start()
        if self.cuda:
            out, n = count_syncs(call)
            self.syncs.append(n)
        else:
            out = call()
        if profiled and index == self.slice.stop - 1:
            self._stop()
        return out

    def features(self, drive: int, index: int, feats) -> None:
        if drive == 0 and index in self.slice:
            kp = feats.keypoints
            n_oct = self.cfg["pyramid"]["num_octaves"]
            per = [(kp.valid & (kp.octave == o)).sum() for o in range(n_oct)]
            self.slice_kps.append((feats, per))

    def global_ba(self, call):
        t0 = time.perf_counter()
        out = call()
        if self.cuda:
            torch.cuda.synchronize()
        self.gba_s.append(time.perf_counter() - t0)
        return out

    def record(self, frontend_ms: list, h: int, w: int) -> dict:
        """The traced run's record for the metrics' readers."""
        rec = {"stage_totals": dict(self.totals),
               "stage_counts": dict(self.counts),
               "syncs": list(self.syncs), "global_ba_s": list(self.gba_s),
               "frontend_ms": list(frontend_ms), "slice": None}
        if self.prof is None:
            return rec
        events = self.prof.events()
        dev = _device_events(events)
        host = _host_ranges(events, STAGE)
        span = [r for r in host if r[0] == "slice"]
        a, b = span[0][1], span[0][2]
        dev = [(n, max(s, a), min(e, b)) for n, s, e in dev
               if e > a and s < b]
        sift_bound = None
        if self.cfg["frontend"] == "sift" and self.slice_kps:
            sift_bound = 0.0
            for feats, per in self.slice_kps:
                B = feats.keypoints.valid.shape[0]
                sift_bound += roofline.bound_s(roofline.sift_call_bytes(
                    self.cfg, B, h, w, [int(n) for n in per]))
        rec["slice"] = {
            "start_s": a, "end_s": b,
            "device": dev,
            "stages": [r for r in host if r[0] != "slice"],
            "frames": self.traffic.batch * len(self.slice),
            "sift_bound_s": sift_bound,
        }
        return rec


def breakdown(rec: dict, top: int = 10) -> dict | None:
    """The slice's device operations that took most time, and its idle
    gaps summed by the host's stage at each gap's middle."""
    sl = rec.get("slice")
    if not sl or not sl["device"]:
        return None
    by_op = defaultdict(float)
    for name, s, e in sl["device"]:
        by_op[name] += e - s
    idle = defaultdict(float)
    for ga, gb in stats.gaps([(s, e) for _, s, e in sl["device"]],
                             sl["start_s"], sl["end_s"]):
        mid = 0.5 * (ga + gb)
        inside = [r for r in sl["stages"] if r[1] <= mid < r[2]]
        name = (max(inside, key=lambda r: r[1])[0] if inside
                else "harness")
        idle[name] += gb - ga
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(idle.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[n, v] for n, v in ops],
            "idle_gaps": [[n, v] for n, v in gaps]}


def frontend_ms(tracker, imgs, reps: int = 10) -> list:
    """ms of `tracker.detect_batch(imgs)` between CUDA events, `reps`
    replays after two."""
    for _ in range(2):
        tracker.detect_batch(imgs)
    out = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        tracker.detect_batch(imgs)
        end.record()
        end.synchronize()
        out.append(start.elapsed_time(end))
    return out

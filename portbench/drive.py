"""The drive protocol and the measured window.

A drive is one recorded sequence processed from a fresh `Tracker`, through
its public entries: `process_batch` of the first `init` frames, then
`process_stream` on `batch`-frame uint8 batches that live on the host, as
decoded frames would, then `finish`, then `global_ba` where the traffic
says so. The window runs drives back to back until its seconds run out;
then it hands in no more frames and calls `finish` on the drive in flight.
The program's shared caches stay warm across drives, as in a mapping
service.

Every frame handed in is timed from the hand-in of its batch (or its init
call) to the return of the call that delivered its pose.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass(frozen=True)
class Traffic:
    """A traffic mix (traffic/<name>.json)."""

    frames: int              # frames of one drive
    frames_per_lap: int      # frames of one circuit of the rectangle
    init: int                # frames of the init's process_batch
    batch: int               # frames of a process_stream batch
    global_ba: bool          # global BA after each complete drive
    warm_drives: int         # whole drives (and global BAs) of the set-up
    profile_batch: int       # first stream batch of the profiled slice
    profile_batches: int     # stream batches in the slice
    check_batches: int       # stream batches whose features are compared

    @classmethod
    def from_dict(cls, d: dict) -> "Traffic":
        p, c = d["profile"], d["check"]
        return cls(frames=d["frames"], frames_per_lap=d["frames_per_lap"],
                   init=d["init"], batch=d["batch"],
                   global_ba=d["global_ba"], warm_drives=d["warm_drives"],
                   profile_batch=p["first_batch"],
                   profile_batches=p["batches"],
                   check_batches=c["batches"])

    def stream_starts(self) -> list:
        """First frame of each process_stream batch."""
        return list(range(self.init, self.frames, self.batch))

    def distinct(self) -> int:
        """Frames to render: a later lap sees the first lap's frames."""
        return min(self.frames, self.frames_per_lap)


class Sequence:
    """One drive's frames on the host: the init's frames and the stream's
    batches (views where a batch is contiguous in the rendered lap)."""

    def __init__(self, frames: np.ndarray, traffic: Traffic):
        lap = len(frames)

        def take(a: int, b: int) -> np.ndarray:
            ids = np.arange(a, b) % lap
            if ids[-1] - ids[0] == b - a - 1:
                return frames[ids[0]:ids[-1] + 1]
            return frames[ids]

        self.traffic = traffic
        self.init = take(0, traffic.init)
        self.batches = [(k, take(k, min(k + traffic.batch, traffic.frames)))
                        for k in traffic.stream_starts()]


class Hooks:
    """Where a traced run adds its measurements; these add nothing."""

    def tracker(self, tracker) -> None:
        """A drive's fresh tracker, before its first call."""

    def stream(self, call, drive: int, index: int):
        """Runs process_stream batch `index` of drive `drive`."""
        return call()

    def global_ba(self, call):
        return call()

    def features(self, drive: int, index: int, feats) -> None:
        """The frontend's output for stream batch `index` of `drive`."""


@dataclass
class DriveRecord:
    index: int
    complete: bool = False
    poses: dict = field(default_factory=dict)    # fid -> (R, t) delivered
    ok: dict = field(default_factory=dict)       # fid -> tracking_ok
    closures: int = 0
    loops: list = field(default_factory=list)   # (frame, frame) a closure
    #                                             joined, earlier first
    relocalizations: int = 0
    seconds: float = 0.0                 # from its tracker to its end


@dataclass
class WindowRecord:
    start: float = 0.0
    end: float = 0.0
    handed: int = 0                      # frames handed in
    latencies: list = field(default_factory=list)   # seconds, delivered
    drives: list = field(default_factory=list)
    captures: dict = field(default_factory=dict)    # ("first" | "last",
    #                                                    batch) -> Features

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def delivered_ok(self) -> int:
        return sum(sum(d.ok.values()) for d in self.drives)

    def lost(self) -> int:
        return sum(len(d.ok) - sum(d.ok.values()) for d in self.drives)

    def undelivered(self) -> int:
        return self.handed - sum(len(d.ok) for d in self.drives)


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def run_drive(make_tracker, seq: Sequence, rec: WindowRecord, index: int,
              deadline: float | None = None, hooks: Hooks | None = None,
              capture=frozenset()) -> DriveRecord:
    """One drive; stops handing in frames once `deadline` (perf_counter
    seconds) has passed. `capture`: stream batch indices whose features
    are kept in rec.captures."""
    hooks = hooks or Hooks()
    traffic = seq.traffic
    t_start = time.perf_counter()
    drive = DriveRecord(index)
    rec.drives.append(drive)
    tracker = make_tracker()
    hooks.tracker(tracker)
    detect = tracker.detect_batch
    current = [None]

    def spy(imgs):
        feats = detect(imgs)
        i = current[0]
        if i is not None:
            hooks.features(index, i, feats)
            if i in capture:
                # the first drive's and the latest drive's
                rec.captures[("first" if index == 0 else "last", i)] = feats
        return feats

    tracker.detect_batch = spy
    handed_at = {}

    def deliver(results, t):
        for fr in results:
            drive.poses[fr.frame_id] = (np.array(fr.R, np.float64),
                                        np.array(fr.t, np.float64))
            drive.ok[fr.frame_id] = bool(fr.tracking_ok)
            rec.latencies.append(t - handed_at[fr.frame_id])

    t = time.perf_counter()
    handed_at.update(dict.fromkeys(range(traffic.init), t))
    rec.handed += traffic.init
    deliver(tracker.process_batch(seq.init, 0), time.perf_counter())
    cut = False
    for i, (k, imgs) in enumerate(seq.batches):
        t = time.perf_counter()
        if deadline is not None and t >= deadline:
            cut = True
            break
        handed_at.update(dict.fromkeys(range(k, k + len(imgs)), t))
        rec.handed += len(imgs)
        current[0] = i
        out = hooks.stream(lambda: tracker.process_stream(imgs, k), index, i)
        current[0] = None
        deliver(out, time.perf_counter())
    deliver(tracker.finish(), time.perf_counter())
    drive.closures = int(tracker.num_loop_closures)
    drive.relocalizations = int(tracker.relocalizations)
    lc = tracker.loop_closer
    if lc is not None:
        drive.loops = [(lc.entries[e.i].frame_id, lc.entries[e.j].frame_id)
                       for e in lc.loop_edges]
    if not cut and traffic.global_ba:
        hooks.global_ba(tracker.global_ba)
    drive.complete = not cut
    drive.seconds = time.perf_counter() - t_start
    return drive


def run_window(make_tracker, seq: Sequence, seconds: float, device,
               hooks: Hooks | None = None, capture=frozenset()):
    """Drives back to back for `seconds`; the window closes when the drive
    in flight has finished and the device is idle. The first drive runs
    to its end whatever the seconds (the check compares its outputs)."""
    rec = WindowRecord()
    sync(device)
    rec.start = time.perf_counter()
    deadline = rec.start + seconds
    index = 0
    while True:
        drive = run_drive(make_tracker, seq, rec, index,
                          deadline if index else None, hooks, capture)
        index += 1
        if not drive.complete or time.perf_counter() >= deadline:
            break
    sync(device)
    rec.end = time.perf_counter()
    return rec


def warm(make_tracker, seq: Sequence, device) -> None:
    """The set-up's warm drives: `warm_drives` whole drives, each with its
    global BA where the mix has one, then `Tracker.prewarm_aux`, which
    captures the rare events' programs. Besides building every program the
    window replays, they keep the card and the host busy long enough that
    the window's first drive runs as fast as its later ones."""
    traffic = seq.traffic
    for _ in range(traffic.warm_drives):
        tracker = make_tracker()
        tracker.process_batch(seq.init, 0)
        for k, imgs in seq.batches:
            tracker.process_stream(imgs, k)
        tracker.finish()
        if traffic.global_ba:
            tracker.global_ba()
    tracker.prewarm_aux()
    sync(device)

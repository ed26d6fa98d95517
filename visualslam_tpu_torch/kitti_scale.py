"""KITTI-scale end-to-end run on one device (the JAX package's
benchmarks/kitti_scale.py):

    python -m visualslam_tpu_torch.kitti_scale [--frames N] [--device cpu]
        [--out KITTI_SCALE_TORCH.json]

~500 KITTI-sized frames through the whole tracker in one process (batched
frontend, the engine with its window BA, loop closure), then the
full-sequence matrix-free global BA, recorded as one JSON artifact:
throughput, accuracy and the global BA's rate, cold (build, the
program's capture on the card, solve, read-back) and warm (the rebuilt
problem solved again: on the card a replay of the cold call's graphs).

The trajectory is the loop rectangle (its path re-sees its starting views,
so loop closure and the pose graph run). Frames are rendered first, in a
process pool, untimed; a warmup tracker runs 24 frames of another world.
Only the lag-1 stream (Tracker.process_stream in batches of 16 after
process_batch of frames 0..7) is timed. When no loop closes, the artifact
carries retrieval diagnostics (the device database's cosine similarity of
keyframe pairs far apart in time, nearest in space first).

`run` is the protocol; chip_smoke.py's full_sequence phase drives the same
function with its own measurements added at the `Hooks` points.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import time

import numpy as np
import torch

from visualslam_tpu_torch.utils.card import device_label, require_device
from visualslam_tpu_torch.utils.config import FAST_CONFIG

FRAMES = 500
WORLD = dict(h=376, w=1248, n_dots=12000, step=0.4)
CONFIG = FAST_CONFIG.replace(ba=FAST_CONFIG.ba.replace(solver="schur_mf"))
INIT = 8            # process_batch: bootstrap + two-view init
BATCH = 16
WARM_FRAMES = 24
WARM_SEED = 7
DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "KITTI_SCALE_TORCH.json")


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def render(frames: int = FRAMES):
    """(sequence, uint8 frames, warmup sequence, its uint8 frames); the
    frames render in a spawn pool, one process per CPU this process may
    use."""
    from visualslam_tpu_torch.io.synthetic import (
        SyntheticSequence,
        render_uint8,
    )

    workers = len(os.sched_getaffinity(0))
    seq = SyntheticSequence(num_frames=frames, trajectory="loop", **WORLD)
    warm_seq = SyntheticSequence(num_frames=WARM_FRAMES, seed=WARM_SEED,
                                 **WORLD)
    t0 = time.perf_counter()
    out = (seq, render_uint8(seq, range(frames), workers), warm_seq,
           render_uint8(warm_seq, range(WARM_FRAMES), workers))
    print(f"[kitti_scale] {frames} + {WARM_FRAMES} frames rendered in "
          f"{time.perf_counter() - t0:.1f} s ({workers} processes)",
          file=sys.stderr)
    return out


def loop_diagnostics(tracker, top: int = 5):
    """For keyframe pairs far apart in time (>= 100 frames), nearest in
    estimated space first: the cosine similarity the device loop database
    records. Tells a failing retrieval gate from no true revisit."""
    lc = tracker.loop_closer
    p = tracker._eng_persist
    if lc is None or p is None or len(lc.entries) < 4:
        return None
    n = min(int(tracker._eng_db_n), p.db_g.shape[0], len(lc.entries))
    G = p.db_g[:n].cpu().numpy()
    fids = np.asarray([e.frame_id for e in lc.entries[:n]])
    centers = np.stack([-e.R.T @ e.t for e in lc.entries[:n]])
    sims = G @ G.T
    out = []
    for i in range(n):
        for j in range(i + 1, n):
            if fids[j] - fids[i] < 100:
                continue
            d = float(np.linalg.norm(centers[j] - centers[i]))
            out.append((d, float(sims[i, j]), int(fids[i]), int(fids[j])))
    out.sort()
    return [{"gt_dist_est_m": round(d, 2), "cosine": round(c, 3),
             "frames": [a, b]} for d, c, a, b in out[:top]]


class Hooks:
    """Where a caller adds its own measurements to `run`; these defaults
    add nothing."""

    def stream(self, tracker):
        """A context manager around the timed stream (process_stream
        calls, finish, synchronize)."""
        return contextlib.nullcontext()

    def step(self, call):
        """Runs each process_stream call and the finish() call."""
        return call()

    def tracked(self, tracker) -> None:
        """After the stream, before the global BA changes the frames."""

    def global_ba(self, tracker, res) -> None:
        """After the cold global BA (res: its GlobalBAResult)."""


def run(seq, frames: np.ndarray, warm_seq, warm_frames: np.ndarray,
        device="cuda", hooks: Hooks | None = None, cfg=CONFIG, kernels=None):
    """The protocol on pre-rendered frames. Returns (the artifact's dict,
    the tracker after its global BA). cfg and kernels (ops.cuda.KERNELS by
    default) are the trackers'."""
    from visualslam_tpu_torch.backend.ba import run_ba_jit
    from visualslam_tpu_torch.slam.evaluation import (
        ate_rmse,
        centers_from_poses,
        rpe,
    )
    from visualslam_tpu_torch.slam.global_ba import (
        build_global_problem,
        global_run_cfg,
    )
    from visualslam_tpu_torch.slam.tracker import Tracker

    from visualslam_tpu_torch.ops.cuda import KERNELS

    dev = require_device(device, "kitti_scale")
    hooks = hooks or Hooks()
    kernels = KERNELS if kernels is None else kernels
    N = len(frames)

    # warmup on another world: allocator, library handles and kernels are
    # ready before the timed stream
    warm = Tracker(cfg, warm_seq.intrinsics, device=dev, kernels=kernels)
    warm.process_batch(warm_frames[:INIT], 0)
    warm.process_stream(warm_frames[INIT:], INIT)
    warm.finish()
    warm.prewarm_aux()
    del warm

    tracker = Tracker(cfg, seq.intrinsics, device=dev, kernels=kernels)
    tracker.process_batch(frames[:INIT], 0)
    _sync(dev)
    with hooks.stream(tracker):
        t0 = time.perf_counter()
        for k in range(INIT, N, BATCH):
            hooks.step(lambda: tracker.process_stream(frames[k:k + BATCH],
                                                      k))
        hooks.step(tracker.finish)
        _sync(dev)
        track_wall = time.perf_counter() - t0
    fps = (N - INIT) / track_wall

    gt = seq.gt_poses[:N]
    est = tracker.trajectory()
    ate_track = float(ate_rmse(centers_from_poses(est),
                               centers_from_poses(gt[:len(est)])))
    loop_diag = (None if tracker.num_loop_closures > 0
                 else loop_diagnostics(tracker))
    inl = [f.num_inliers for f in tracker.frames if f.num_inliers > 0]
    tracked = dict(
        keyframes=int(sum(f.is_keyframe for f in tracker.frames)),
        loop_closures=int(tracker.num_loop_closures),
        relocalizations=int(tracker.relocalizations),
        landmarks_live=int(tracker.map.lm_valid.sum()),
        mean_inliers=round(float(np.mean(inl)), 1) if inl else 0.0)
    hooks.tracked(tracker)

    _sync(dev)
    t0 = time.perf_counter()
    res = tracker.global_ba()
    gba_wall_cold = time.perf_counter() - t0
    est2 = tracker.trajectory()
    gt2 = gt[:len(est2)]
    ate_gba = float(ate_rmse(centers_from_poses(est2),
                             centers_from_poses(gt2)))
    t_rmse, r_rmse = rpe(est2, gt2)
    hooks.global_ba(tracker, res)

    # the warm rate: the rebuilt problem (post-writeback values) solved
    # again at the same shapes, configuration and iteration count, so it
    # replays the program the cold call captured
    p2, _ = build_global_problem(tracker.map, device=dev)
    run_cfg = global_run_cfg(cfg.ba, p2)
    _sync(dev)
    t0 = time.perf_counter()
    run_ba_jit(p2, run_cfg).R.sum().item()
    gba_wall_warm = time.perf_counter() - t0

    h, w = frames.shape[1:3]
    out = {
        "device": device_label(dev),
        "frames": N, "image": f"{h}x{w}", "profile": "fast",
        "batch": BATCH,
        "sequence_fps": round(fps, 2),
        "track_wall_s": round(track_wall, 2),
        **tracked,
        "ate_tracked_m": round(ate_track, 4),
        "global_ba": {
            "solver": cfg.ba.solver,
            "cameras": int(res.n_cameras),
            "landmarks": int(res.n_landmarks),
            "observations": int(res.n_observations),
            "initial_cost": float(res.initial_cost),
            "final_cost": float(res.cost),
            "wall_s_cold_incl_compile": round(gba_wall_cold, 2),
            "wall_s_warm": round(gba_wall_warm, 2),
            "lm_iters_per_s_warm": round(
                cfg.ba.iters / max(gba_wall_warm, 1e-9), 2),
        },
        "ate_after_gba_m": round(ate_gba, 4),
        "rpe_trans_m": round(float(t_rmse), 4),
        "rpe_rot_deg": round(float(r_rmse), 4),
    }
    if loop_diag is not None:
        out["loop_retrieval_diagnostics"] = loop_diag
    return out, tracker


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(prog="visualslam_tpu_torch.kitti_scale")
    ap.add_argument("--frames", type=int, default=FRAMES)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the card)")
    ap.add_argument("--out", default=None,
                    help="output file (default KITTI_SCALE_TORCH.json at "
                         "the repository root)")
    args = ap.parse_args(argv)
    require_device(args.device, "kitti_scale")
    out, _ = run(*render(args.frames), device=args.device)
    path = args.out or DEFAULT_OUT
    with open(path, "w") as f:
        json.dump(out, f, indent=2)
    print(json.dumps(out))
    print(f"wrote {path}", file=sys.stderr)


if __name__ == "__main__":
    main()

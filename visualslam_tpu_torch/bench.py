"""Benchmark entry point of the port; prints ONE JSON line with the keys of
the JAX package's bench.py:

    python -m visualslam_tpu_torch.bench        # one CUDA device

Headline metric: end-to-end sequence throughput (frames/s per card) of the
whole SLAM system, `Tracker.process_stream` over 96 frames of the 376x1248
synthetic sequence in batches of 16 uint8 frames under FAST_CONFIG, after
`process_batch` of its first 8 frames (bootstrap + two-view init) outside
the timed region; the median of 3 runs, each on a fresh tracker, after a
warmup tracker on 24 frames of another seed. vs_baseline = value / 30
(the repository's north-star frames/s). The frontend alone (the
tracker's frontend program on 16-frame uint8 batches on the device,
`torch.cuda.synchronize()` around the timed calls) is an extra key, as in
bench.py.
"""

from __future__ import annotations

import json
import sys
import time

import numpy as np
import torch

from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.utils.config import FAST_CONFIG, SlamConfig

BASELINE_FPS = 30.0
BATCH = 16
N_BATCH_BUFFERS = 4
ITERS = 12
SEQ_FRAMES = 96
INIT_FRAMES = 8
H, W = 376, 1248


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def render_sequence(num_frames: int, seed: int = 0):
    """(uint8 frames [F, 376, 1248], the SyntheticSequence) of the bench's
    world: 8000 dots, 0.4 units per frame."""
    seq = SyntheticSequence(num_frames=num_frames, h=H, w=W, n_dots=8000,
                            step=0.4, seed=seed)
    frames = np.stack([seq.frame(k) for k in range(num_frames)])
    return np.clip(frames * 255.0, 0, 255).astype(np.uint8), seq


def bench_frontend(cfg: SlamConfig = FAST_CONFIG, device="cuda",
                   kernels: Kernels = KERNELS) -> float:
    """Frames/s of the tracker's frontend program (`Tracker.detect_batch`,
    a replay of its captured graph on the card and the copy of its
    features) on random uint8 16-frame batches on the device (distinct
    buffers), ITERS calls after two warmup calls."""
    fe = Tracker(cfg, np.ones(4, np.float32), device=device,
                 kernels=kernels, loop_closure=False).detect_batch
    rng = np.random.default_rng(0)
    batches = [torch.from_numpy(rng.integers(0, 256, (BATCH, H, W),
                                             dtype=np.uint8)).to(device)
               for _ in range(N_BATCH_BUFFERS)]
    for i in range(2):
        fe(batches[i])
    _sync(device)
    t0 = time.perf_counter()
    for i in range(ITERS):
        fe(batches[i % N_BATCH_BUFFERS])
    _sync(device)
    return ITERS * BATCH / (time.perf_counter() - t0)


def warmup(cfg: SlamConfig = FAST_CONFIG, device="cuda",
           kernels: Kernels = KERNELS) -> None:
    """A tracker over 24 frames of another seed: allocator, cuBLAS /
    cuSOLVER handles and kernel libraries are ready before the timed runs."""
    frames, seq = render_sequence(24, seed=7)
    warm = Tracker(cfg, seq.intrinsics, device=device, kernels=kernels)
    warm.process_batch(frames[:INIT_FRAMES], 0)
    warm.process_stream(frames[INIT_FRAMES:24], INIT_FRAMES)
    warm.finish()
    _sync(device)


def run_once(frames: np.ndarray, intrinsics, cfg: SlamConfig = FAST_CONFIG,
             device="cuda", kernels: Kernels = KERNELS, timer=None):
    """One fresh tracker over `frames`: process_batch of the first
    INIT_FRAMES (untimed), then process_stream in batches of BATCH and
    finish (timed). Returns (tracker, timed seconds)."""
    tracker = Tracker(cfg, intrinsics, device=device, kernels=kernels)
    tracker.process_batch(frames[:INIT_FRAMES], 0)
    _sync(device)
    tracker.timer = timer
    t0 = time.perf_counter()
    for k in range(INIT_FRAMES, len(frames), BATCH):
        tracker.process_stream(frames[k:k + BATCH], k)
    tracker.finish()
    _sync(device)
    return tracker, time.perf_counter() - t0


def diagnostics(tracker: Tracker) -> dict:
    """bench.py's per-run keys."""
    inl = [f.num_inliers for f in tracker.frames if f.num_inliers > 0]
    return {
        "seq_frames": len(tracker.frames) - INIT_FRAMES,
        "keyframes": int(sum(f.is_keyframe for f in tracker.frames)),
        "landmarks": int(tracker.map.lm_valid.sum()),
        "mean_inliers": float(np.mean(inl or [0])),
    }


def bench_sequence(cfg: SlamConfig = FAST_CONFIG, runs: int = 3,
                   device="cuda", kernels: Kernels = KERNELS):
    """(median frames/s over `runs`, diagnostics of the last run with the
    sorted runs under "fps_runs")."""
    frames, seq = render_sequence(SEQ_FRAMES + INIT_FRAMES)
    warmup(cfg, device, kernels)
    fps_runs, diag = [], {}
    for _ in range(runs):
        tracker, seconds = run_once(frames, seq.intrinsics, cfg, device,
                                    kernels)
        fps_runs.append(SEQ_FRAMES / seconds)
        diag = diagnostics(tracker)
    fps_runs.sort()
    diag["fps_runs"] = [round(v, 2) for v in fps_runs]
    return fps_runs[len(fps_runs) // 2], diag


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device")
    cfg = FAST_CONFIG
    frontend_fps = bench_frontend(cfg)
    seq_fps, diag = bench_sequence(cfg, runs=3)
    print(f"[bench] device={torch.cuda.get_device_name(0)} "
          f"frontend={cfg.frontend} image={H}x{W} batch={BATCH} "
          f"frontend_fps={frontend_fps:.2f} sequence_fps={seq_fps:.2f} "
          f"diag={diag}", file=sys.stderr)
    print(json.dumps({
        "metric": "sequence_frames_per_s_per_chip",
        "value": round(seq_fps, 3),
        "unit": "frames/s",
        "vs_baseline": round(seq_fps / BASELINE_FPS, 3),
        "frontend_frames_per_s_per_chip": round(frontend_fps, 3),
        **diag,
    }))


if __name__ == "__main__":
    main()

"""Command-line entry points of the port (visualslam_tpu/cli.py):

    python -m visualslam_tpu_torch.cli detect IMAGE [--frontend sift|orb|harris]
    python -m visualslam_tpu_torch.cli run {--synthetic N | --kitti ROOT --seq 00}
    python -m visualslam_tpu_torch.cli two-view IMAGE1 IMAGE2
    python -m visualslam_tpu_torch.cli eval EST_POSES GT_POSES
    python -m visualslam_tpu_torch.cli accuracy [--out ACCURACY_TORCH.md]

`run`, `two-view`, `accuracy` and `detect` take `--device` (default
`cuda`: the card; `cpu` runs the port's plain versions on the CPU).
`detect` runs the DEFAULT (reference) profile with any of the three
frontends; `run` takes `--profile fast|reference`, `--frontend` and
`--pipeline` (stage-overlapped detection, parallel/pipeline.py).
`benchmark` raises NotImplementedError: the JAX package's
benchmarks/harness.py is not ported.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np


def cmd_detect(args) -> None:
    import torch

    from visualslam_tpu_torch.frontend import detect_and_describe
    from visualslam_tpu_torch.io.serialization import save_descriptors_dat
    from visualslam_tpu_torch.models.types import Features, Keypoints
    from visualslam_tpu_torch.slam.viz import draw_keypoints
    from visualslam_tpu_torch.utils.config import DEFAULT_CONFIG
    from visualslam_tpu_torch.utils.images import load_gray

    cfg = DEFAULT_CONFIG.replace(frontend=args.frontend)
    img = load_gray(args.image)
    f = detect_and_describe(
        torch.as_tensor(img, device=args.device)[None], cfg)
    feats = Features(Keypoints(*(x[0] for x in f.keypoints)),
                     f.descriptors[0])
    n = int(feats.keypoints.count())
    print(f"detected {n} keypoints ({args.frontend}) on {args.image} "
          f"{img.shape}")
    out_base = args.out or os.path.splitext(os.path.basename(args.image))[0]
    draw_keypoints(img, feats, out_base + "_keypoints.png")
    v = feats.keypoints.valid.cpu().numpy()
    # ORB's packed uint32 words are written as their float32 values
    desc = feats.descriptors.cpu().numpy().astype(np.float32)[v]
    save_descriptors_dat(out_base + "_descriptors.dat", desc)
    print(f"wrote {out_base}_keypoints.png and {out_base}_descriptors.dat")


def _make_sequence(args):
    if args.kitti:
        from visualslam_tpu_torch.io.kitti import KittiOdometrySequence

        return KittiOdometrySequence(args.kitti, args.seq)
    from visualslam_tpu_torch.io.kitti import SyntheticSequence

    return SyntheticSequence(
        num_frames=args.synthetic, h=args.height, w=args.width,
        n_dots=args.dots, trajectory=args.trajectory)


def cmd_run(args) -> None:
    from visualslam_tpu_torch.io.serialization import save_kitti_poses
    from visualslam_tpu_torch.io.synthetic import render_uint8
    from visualslam_tpu_torch.slam.checkpoint import (
        load_checkpoint,
        save_checkpoint,
    )
    from visualslam_tpu_torch.slam.evaluation import (
        ate_rmse,
        centers_from_poses,
        rpe,
    )
    from visualslam_tpu_torch.slam.tracker import Tracker
    from visualslam_tpu_torch.slam.viz import draw_trajectory
    from visualslam_tpu_torch.utils.config import DEFAULT_CONFIG, FAST_CONFIG

    seq = _make_sequence(args)
    info = seq.info()
    base = FAST_CONFIG if args.profile == "fast" else DEFAULT_CONFIG
    cfg = base.replace(frontend=args.frontend)
    tracker = Tracker(cfg, info.intrinsics, device=args.device)
    start = 0
    if args.resume and os.path.exists(args.resume):
        load_checkpoint(args.resume, tracker)
        start = tracker.frames[-1].frame_id + 1 if tracker.frames else 0
        print(f"resumed from {args.resume} at frame {start}")

    ckpt_path = args.checkpoint or "slam_ckpt.npz"
    B = max(1, args.batch)

    if not args.no_prewarm and B > 1:
        # a throwaway tracker on a warmup world of the same shapes (another
        # seed, never the run's own frames): allocator, cuBLAS / cuSOLVER
        # handles and the kernel libraries are ready before the loop
        from visualslam_tpu_torch.io.synthetic import SyntheticSequence

        t_w = time.perf_counter()
        h, w = info.image_size
        warm_seq = SyntheticSequence(num_frames=3 * B, h=h, w=w, seed=777)
        wf = np.stack([warm_seq.frame(k) for k in range(3 * B)])
        if (not args.kitti
                or np.issubdtype(np.asarray(seq.frame(0)).dtype,
                                 np.integer)):
            # the main loop's dtype (synthetic mode ships uint8)
            wf = np.clip(wf * 255.0, 0, 255).astype(np.uint8)
        warm = Tracker(cfg, warm_seq.info().intrinsics, device=args.device)
        warm.process_batch(wf[:B], 0)
        for k in range(B, 3 * B, B):
            warm.process_stream(wf[k:k + B], k)
        warm.finish()
        del warm
        print(f"prewarm (warmup world): {time.perf_counter() - t_w:.1f}s")

    pre = None
    if not args.kitti:
        # pre-render the synthetic sequence outside the timed loop, as
        # 8-bit frames (the device normalizes); a frame depends on its
        # index alone, so --render-workers processes render in parallel
        t_r = time.perf_counter()
        ids = range(start, len(seq))
        pre = dict(zip(ids, render_uint8(seq, ids, args.render_workers)))
        print(f"pre-rendered {len(pre)} synthetic frames in "
              f"{time.perf_counter() - t_r:.1f}s")

    t0 = time.perf_counter()

    def batch_ids():
        k = start
        while k < len(seq):
            yield list(range(k, min(k + B, len(seq))))
            k = min(k + B, len(seq))

    def rendered_batches():
        """Frames by batch: the pre-rendered ones, or a producer thread
        loading ahead of the device loop (bounded queue)."""
        import queue
        import threading

        if pre is not None:
            for ids in batch_ids():
                yield ids, np.stack([pre[i] for i in ids])
            return

        q: "queue.Queue" = queue.Queue(maxsize=3)

        def produce():
            for ids in batch_ids():
                q.put((ids, np.stack([seq.frame(i) for i in ids])))
            q.put(None)

        threading.Thread(target=produce, daemon=True).start()
        while True:
            item = q.get()
            if item is None:
                return
            yield item

    if args.pipeline:
        # stage-overlapped: detection of batch k+1 is dispatched before
        # tracking / BA consumes batch k (parallel/pipeline.py)
        from visualslam_tpu_torch.parallel.pipeline import pipelined_batches

        def run_batches():
            yield from pipelined_batches(
                tracker, ((ids[0], imgs) for ids, imgs in
                          rendered_batches()))
    else:
        def run_batches():
            # the lag-1 stream: each batch's engine call is dispatched
            # before the previous batch's telemetry is read
            # (Tracker.process_stream)
            for ids, imgs in rendered_batches():
                if len(ids) > 1:
                    yield ids, tracker.process_stream(imgs, ids[0])
                else:
                    yield ids, [tracker.process(imgs[0], ids[0])]

    try:
        for ids, results in run_batches():
            el = time.perf_counter() - t0
            fps = (ids[-1] - start + 1) / el
            if results:
                res = results[-1]
                print(f"frame {res.frame_id}/{len(seq)} "
                      f"inliers={res.num_inliers} kf={res.is_keyframe} "
                      f"loops={tracker.num_loop_closures} "
                      f"{fps:.1f} fps", flush=True)
            if (args.checkpoint_every
                    and (ids[-1] + 1) % args.checkpoint_every < B):
                tracker.finish()    # land in-flight batches before saving
                save_checkpoint(ckpt_path, tracker)
        tracker.finish()
    except Exception as e:  # failure detection: save state, surface it
        # as the reference, without finish() (reference defect 2,
        # ROADMAP.md C): the in-flight batch is not in the checkpoint
        save_checkpoint(ckpt_path, tracker)
        print(f"run FAILED ({type(e).__name__}: {e}); emergency "
              f"checkpoint -> {ckpt_path}", flush=True)
        raise
    wall = time.perf_counter() - t0
    if args.global_ba:
        res = tracker.global_ba()
        print(f"global BA: {res.n_cameras} keyframes, {res.n_landmarks} "
              f"landmarks, {res.n_observations} obs; cost "
              f"{res.initial_cost:.3e} -> {res.cost:.3e}")
    est = tracker.trajectory()
    out = args.out or "poses_est.txt"
    save_kitti_poses(out, est)
    if args.metrics:
        with open(args.metrics, "w") as f:
            for row in tracker.metrics():
                f.write(json.dumps(row) + "\n")
        print(f"wrote {args.metrics}")
    print(f"{len(seq) - start} frames in {wall:.1f}s "
          f"({(len(seq) - start) / wall:.2f} fps) -> {out}")
    if info.gt_poses is not None:
        gt = info.gt_poses[: len(est)]
        ate = ate_rmse(centers_from_poses(est), centers_from_poses(gt))
        t_rmse, r_rmse = rpe(est, gt)
        print(f"ATE (Sim3-aligned): {ate:.4f} m | RPE: {t_rmse:.4f} m, "
              f"{r_rmse:.4f} deg")
        draw_trajectory(est, "trajectory.png", gt)
        print("wrote trajectory.png")


def cmd_two_view(args) -> None:
    """Two-view reconstruction demo: detect+match+essential+triangulate."""
    import torch

    from visualslam_tpu_torch.frontend import detect_and_describe
    from visualslam_tpu_torch.geometry.ransac import generator
    from visualslam_tpu_torch.models.types import Features, Keypoints
    from visualslam_tpu_torch.slam.two_view import two_view_from_features
    from visualslam_tpu_torch.slam.viz import draw_matches
    from visualslam_tpu_torch.utils.config import FAST_CONFIG
    from visualslam_tpu_torch.utils.images import load_gray

    cfg = FAST_CONFIG.replace(frontend=args.frontend)
    img1 = load_gray(args.image1)
    img2 = load_gray(args.image2)
    fx = args.fx or float(img1.shape[1])     # default focal: image width
    intr = torch.tensor([fx, fx, img1.shape[1] / 2, img1.shape[0] / 2],
                        device=args.device)

    def detect(img):
        f = detect_and_describe(torch.as_tensor(img, device=args.device)[None],
                                cfg)
        return Features(Keypoints(*(x[0] for x in f.keypoints)),
                        f.descriptors[0])

    fa, fb = detect(img1), detect(img2)
    res = two_view_from_features(fa, fb, intr, cfg,
                                 generator(cfg.ransac.seed, args.device))
    n_m = int(res.matches.count())
    n_i = int(res.num_inliers)
    R = res.R.cpu().numpy()
    t = res.t.cpu().numpy()
    angle = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    print(f"matches: {n_m}  epipolar+cheirality inliers: {n_i}")
    print(f"relative rotation: {angle:.2f} deg | translation direction: "
          f"{np.round(t / max(np.linalg.norm(t), 1e-9), 3).tolist()}")
    draw_matches(img1, img2, fa, fb, res.matches, "two_view_matches.png")
    print("wrote two_view_matches.png")


def cmd_eval(args) -> None:
    from visualslam_tpu_torch.io.serialization import load_kitti_poses
    from visualslam_tpu_torch.slam.evaluation import (
        ate_rmse,
        centers_from_poses,
        rpe,
    )

    est = load_kitti_poses(args.est)
    gt = load_kitti_poses(args.gt)
    n = min(len(est), len(gt))
    ate = ate_rmse(centers_from_poses(est[:n]), centers_from_poses(gt[:n]))
    t_rmse, r_rmse = rpe(est[:n], gt[:n])
    print(json.dumps({"ate_m": ate, "rpe_trans_m": t_rmse,
                      "rpe_rot_deg": r_rmse, "frames": n}))


def cmd_benchmark(args) -> None:
    raise NotImplementedError(
        "the benchmark harness (the JAX package's benchmarks/harness.py) is "
        "not ported; the port's benchmark entry is python -m "
        "visualslam_tpu_torch.bench")


# The reference's scenario set (visualslam_tpu/cli.py, cmd_accuracy):
# (name, profile, SyntheticSequence kwargs or "photo", global BA, batch).
_BENCH_WORLD = dict(h=376, w=1248, n_dots=8000, step=0.4)
SCENARIOS = [
    ("dolly-60", "fast", dict(num_frames=60), False, 8),
    ("dolly-60", "reference", dict(num_frames=60), False, 8),
    ("arc-60", "fast", dict(num_frames=60, trajectory="arc"), False, 8),
    ("loop-96", "fast", dict(num_frames=96, trajectory="loop"), False, 8),
    ("dolly-100+gba", "fast", dict(num_frames=100), True, 8),
    ("arc-60", "fast", dict(num_frames=60, trajectory="arc"), False, 16),
    ("bench-96", "fast", dict(num_frames=96, **_BENCH_WORLD), False, 16),
    ("bench-96", "fast", dict(num_frames=96, **_BENCH_WORLD), False, 8),
    ("bench-96", "reference", dict(num_frames=96, **_BENCH_WORLD), False,
     16),
    ("bench-loop-256", "fast",
     dict(num_frames=256, h=376, w=1248, n_dots=12000, step=0.4,
          trajectory="loop", laps=2), False, 16),
    ("photo-loop-100", "fast", "photo", False, 8),
]
_ROW_KEYS = ("scenario", "profile", "commit", "frames", "batch", "fps",
             "ate_m", "rpe_trans_m", "rpe_rot_deg", "mean_inliers",
             "min_inliers", "keyframes", "loop_closures", "note")


def _not_run(name, profile, batch, commit, why) -> dict:
    row = dict.fromkeys(_ROW_KEYS, "-")
    row.update(scenario=name, profile=profile, commit=commit, batch=batch,
               note=f"not run: {why}")
    return row


def cmd_accuracy(args) -> None:
    """Write the port's accuracy table (ACCURACY_TORCH.md by default; the
    JAX package's ACCURACY.md is its own): the reference's scenarios, each
    row = (scenario, profile, commit, frames, ATE, RPE, inlier stats). A
    scenario the port cannot run yet gets a row that says why."""
    from visualslam_tpu_torch.io.synthetic import SyntheticSequence
    from visualslam_tpu_torch.slam.evaluation import (
        ate_rmse,
        centers_from_poses,
        rpe,
    )
    from visualslam_tpu_torch.slam.tracker import Tracker
    from visualslam_tpu_torch.utils.config import DEFAULT_CONFIG, FAST_CONFIG

    try:
        commit = subprocess.run(
            ["git", "rev-parse", "--short", "HEAD"], capture_output=True,
            text=True, cwd=os.path.dirname(os.path.dirname(
                os.path.abspath(__file__)))).stdout.strip() or "unknown"
    except OSError:
        commit = "unknown"

    rows = []
    for name, profile, kw, use_gba, batch in SCENARIOS:
        if kw == "photo":
            if not args.photo:
                rows.append(_not_run(
                    name, profile, batch, commit,
                    "needs the reference's photograph home.jpg (--photo "
                    "PATH), which the repository does not hold"))
                print(json.dumps(rows[-1]), flush=True)
                continue
            from visualslam_tpu_torch.io.photo_seq import PhotoSequence
            from visualslam_tpu_torch.utils.images import load_gray

            seq = PhotoSequence(load_gray(args.photo), num_frames=100,
                                trajectory="loop")
            intr = seq.intrinsics
            gt_all = seq.gt_poses()
            init_depth = 1.3
            cfg = FAST_CONFIG.replace(
                loop=FAST_CONFIG.loop.replace(exclude_recent=6))
        else:
            seq = SyntheticSequence(**kw)
            info = seq.info()
            intr = info.intrinsics
            gt_all = info.gt_poses
            init_depth = 20.0
            cfg = FAST_CONFIG if profile == "fast" else DEFAULT_CONFIG
        frames = np.stack([seq.frame(k) for k in range(len(seq))])
        # a warmup tracker at this (config, shape), so the fps column
        # measures the pipeline
        h_w, w_w = frames.shape[1:3]
        warm_seq = SyntheticSequence(num_frames=24, h=h_w, w=w_w,
                                     n_dots=2000, seed=11)
        warm = Tracker(cfg, warm_seq.info().intrinsics,
                       init_depth=init_depth, device=args.device)
        wf = np.stack([warm_seq.frame(k) for k in range(24)])
        warm.process_batch(wf[:8], 0)
        warm.process_stream(wf[8:8 + batch], 8)
        warm.finish()
        del warm

        tracker = Tracker(cfg, intr, init_depth=init_depth,
                          device=args.device)
        t0 = time.perf_counter()
        for k in range(0, len(frames), batch):
            tracker.process_stream(frames[k:k + batch], k)
        tracker.finish()
        wall = time.perf_counter() - t0
        if use_gba:
            tracker.global_ba()
        est = tracker.trajectory()
        gt = gt_all[: len(est)]
        ate = ate_rmse(centers_from_poses(est), centers_from_poses(gt))
        t_rmse, r_rmse = rpe(est, gt)
        inl = [f.num_inliers for f in tracker.frames if f.num_inliers > 0]
        rows.append({
            "scenario": name, "profile": profile, "commit": commit,
            "frames": len(frames), "batch": batch,
            "fps": round(len(frames) / wall, 2),
            "ate_m": round(float(ate), 4),
            "rpe_trans_m": round(float(t_rmse), 4),
            "rpe_rot_deg": round(float(r_rmse), 4),
            "mean_inliers": round(float(np.mean(inl)), 1) if inl else 0.0,
            "min_inliers": int(np.min(inl)) if inl else 0,
            "keyframes": int(sum(f.is_keyframe for f in tracker.frames)),
            "loop_closures": tracker.num_loop_closures,
            "note": "",
        })
        print(json.dumps(rows[-1]), flush=True)
        if name.startswith("loop") and tracker.num_loop_closures == 0:
            print("WARNING: loop scenario closed no loops", file=sys.stderr)

    out = args.out or "ACCURACY_TORCH.md"
    with open(out, "w") as f:
        f.write("# ACCURACY_TORCH — the port's sequence-level results\n\n")
        f.write("Regenerate with: `python -m visualslam_tpu_torch.cli "
                f"accuracy --device {args.device}`\n\nEvery row is produced "
                "by that command on the commit and the device shown "
                f"({args.device}).\n\n")
        f.write("| " + " | ".join(_ROW_KEYS) + " |\n")
        f.write("|" + "---|" * len(_ROW_KEYS) + "\n")
        for r in rows:
            f.write("| " + " | ".join(str(r[k]) for k in _ROW_KEYS) + " |\n")
        f.write("\nScenario definitions live in "
                "`visualslam_tpu_torch/cli.py` (`SCENARIOS`): "
                "SyntheticSequence splat worlds with exact ground truth; ATE "
                "is Sim(3)-aligned RMSE.\n")
    print(f"wrote {out}")


def main(argv=None) -> None:
    p = argparse.ArgumentParser(prog="visualslam_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_arg(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device (default: the card; cpu runs "
                             "the plain versions on the CPU)")

    d = sub.add_parser("detect", help="detect+describe on one image")
    d.add_argument("image")
    d.add_argument("--frontend", default="sift",
                   choices=["sift", "orb", "harris"])
    d.add_argument("--out", default=None)
    device_arg(d)
    d.set_defaults(fn=cmd_detect)

    r = sub.add_parser("run", help="run SLAM over a sequence")
    r.add_argument("--kitti", default=None, help="KITTI odometry root")
    r.add_argument("--seq", default="00")
    r.add_argument("--synthetic", type=int, default=50,
                   help="use N synthetic frames (when --kitti not given)")
    r.add_argument("--width", type=int, default=376,
                   help="synthetic world frame width")
    r.add_argument("--height", type=int, default=240,
                   help="synthetic world frame height")
    r.add_argument("--dots", type=int, default=1500,
                   help="synthetic world landmark count")
    r.add_argument("--trajectory", default="dolly",
                   choices=["dolly", "arc", "loop"],
                   help="synthetic camera path")
    r.add_argument("--frontend", default="sift",
                   choices=["sift", "orb", "harris"])
    r.add_argument("--profile", default="fast",
                   choices=["fast", "reference"],
                   help="fast: production throughput profile; reference: "
                        "reference-parity pyramid (2x upsample, 4 octaves)")
    r.add_argument("--out", default=None)
    r.add_argument("--checkpoint", default=None)
    r.add_argument("--checkpoint-every", type=int, default=0)
    r.add_argument("--resume", default=None)
    r.add_argument("--metrics", default="metrics.jsonl",
                   help="write per-frame metrics JSON lines here "
                        "(default metrics.jsonl; '' writes none)")
    r.add_argument("--pipeline", action="store_true",
                   help="stage-overlapped execution: detection of "
                        "batch k+1 dispatched before batch k is tracked")
    r.add_argument("--batch", type=int, default=8,
                   help="frames per batched detection call (1 = per-frame)")
    r.add_argument("--no-prewarm", action="store_true",
                   help="skip the warmup tracker before the run")
    r.add_argument("--render-workers", type=int, default=1,
                   help="processes that pre-render the synthetic frames")
    r.add_argument("--global-ba", action="store_true",
                   help="full-sequence bundle adjustment over the entire "
                        "keyframe history after the run")
    device_arg(r)
    r.set_defaults(fn=cmd_run)

    tv = sub.add_parser("two-view",
                        help="two-view reconstruction on an image pair")
    tv.add_argument("image1")
    tv.add_argument("image2")
    tv.add_argument("--frontend", default="sift",
                    choices=["sift", "orb", "harris"])
    tv.add_argument("--fx", type=float, default=None,
                    help="focal length in pixels (default: image width)")
    device_arg(tv)
    tv.set_defaults(fn=cmd_two_view)

    e = sub.add_parser("eval", help="ATE/RPE between two pose files")
    e.add_argument("est")
    e.add_argument("gt")
    e.set_defaults(fn=cmd_eval)

    b = sub.add_parser("benchmark", help="run the benchmark harness "
                                         "(not ported)")
    b.add_argument("--full", action="store_true")
    b.set_defaults(fn=cmd_benchmark)

    a = sub.add_parser("accuracy",
                       help="write the port's accuracy table")
    a.add_argument("--out", default=None,
                   help="output file (default ACCURACY_TORCH.md)")
    a.add_argument("--photo", default=None,
                   help="the reference's home.jpg, for photo-loop-100")
    device_arg(a)
    a.set_defaults(fn=cmd_accuracy)

    args = p.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()

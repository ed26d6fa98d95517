"""Drive the PyTorch + CUDA port's slices once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

The benchmark's main path at its own shapes: batches of 16 uint8 frames of
376x1248 from the synthetic sequence. Eight paths run, each with the
launch counters reset just before it and read just after:

  - the frontend slice: the batched SIFT frontend (FAST_CONFIG, 3 octaves)
    and each consecutive pair of frames matched;
  - the tracking slice: the frontend under TRACK_CONFIG (FAST_CONFIG with
    blur_mode="pallas" and match.impl="pallas", the two switches that put
    the blur and the streaming 2-NN kernels on the path), a ground-truth
    bootstrap of two keyframes, track_batch over the batch, one keyframe
    promotion with triangulation, and the window BA;
  - the engine slice: the frontend under ENGINE_CONFIG (TRACK_CONFIG with
    extrema_impl="pallas", the switch that puts the score-map kernel on the
    path) on frames 0-47 as three batches, the ground-truth bootstrap, and
    the engine batch over the three batches (tracking, in-batch promotions
    with window BA, triangulation, loop-database append, retrieval and
    verification), replayed from engine_programs' captured CUDA graphs;
  - the sequence: the bench's protocol through Tracker.process_stream;
  - the reference profile: DEFAULT_CONFIG (2x upsample to 752x2496, 4
    octaves, float32 patch kernels), the frontend and bench-96's reference
    row (`cli accuracy`) through Tracker.process_stream;
  - the per-stage harness (`cli benchmark`, harness.py): DEFAULT_CONFIG's
    pyramid, SIFT and ORB frontends, matching, RANSAC, one BA iteration,
    rotated patches and PnP at the JAX harness's shapes;
  - the full sequence: 500 frames of the loop rectangle through the
    tracker with the matrix-free BA, loop closure and the full-sequence
    global BA (kitti_scale.py, benchmarks/kitti_scale.py's protocol);
  - the parallel paths over an in-process mesh (parallel/): the
    data-parallel frontend, four shards of FAST_CONFIG frames on the card.

Phases, each printing its own lines:

  1. device    the card's name and power limit, CUDA version; TF32 off
  2. build     nvcc-compiles the kernels from csrc/ and the latency
               probes tests/add_chain.cu and tests/rotation_chain.cu, one
               process per source, all at once (timed, with the
               compiler's register / spill report)
  3. kernels   each kernel against its plain version on the card at the
               main path's shapes: the extrema winners and the score map
               bit for bit and equal run to run at each of the 3 octaves
               (the candidates that follow at octave 0), timed per octave
               and per batch (the sum), the orientation histogram and the
               descriptor (reading the gradient levels in place, the
               descriptor on the spawned keypoints) within
               1e-4 * (1 + max |plain|) and equal run to run, the blur
               bit for bit, the 2-NN within 1e-5 * (1 + max |plain|) on
               valid rows with its indices equal off near-ties (one
               tracked frame and 15 pairs), the score map bit for bit;
               each kernel's time per wrapper call (CUDA events) and
               alone on the device (profiler, with its launches per
               call) beside its bound and, where one PyTorch call
               computes the same function, that call's time; the time of
               the patch stack / cast / crop / re-gather the kernel path
               no longer runs; the fixed-order segment sum of BA and the
               pose graph against CPU index_add_ bit for bit, in float32
               and float64, at the global BA's, the window grid's and the
               256-node pose graph's shapes, one segment of 100000 rows
               and power-law segment lengths (widths 1 to 300), equal run
               to run and replayed from a CUDA graph at the window BA's
               and pose graph's shapes; the dependent-add latency of
               float32 and float64 (cycles, ns); each float32 sum timed
               per call and alone beside its bound (the larger of its
               bytes and its longest segment's chain of adds), the plain
               version, the deterministic index_add_ (per call, alone,
               equal bits on the three main shape sets) and the atomic
               index_add_; the DLT triangulation kernel on the engine's
               1024 match slots (keyframe 8, frame 12) bit for bit
               against its float32 replay on the CPU and against the
               plain version (cuSOLVER eigh) under the eigengap gate of
               ops/cuda/triangulate.py, the replay's off-diagonal norms
               per Jacobi sweep, timed beside its bound, the plain version
               and torch.linalg.eigh; the two-view solvers' sym_eigh and
               svd3 on the init's own matrices (frames 0 -> 8: the 512
               8-point normal matrices and the refit's, the five-point's
               128 9x9 and 1280 10x10 systems, the 512 Fs, the refit Fs
               and essential matrices) bit for bit against their replays
               on the CPU and against cuSOLVER under the
               eigenvalue-cluster gate of ops/cuda/small_linalg.py, the
               off-diagonal norms per sweep, the 8-point batches timed
               beside their bounds, the plain version and torch.linalg
               with and without its status read; the latency of one
               dependent Jacobi rotation in float64 and of the float32
               kernels' own rotations (cycles, ns; tests/rotation_chain.cu)
               and the solver kernels' chain floors (the rotations of the
               longest matrix x the fastest latency of arithmetic that
               keeps their bits)
  4. slice     the frontend + matching through the public entry points;
               the plain path on the same batch as the reference; keypoint
               and match floors; frames/s of both paths; the frontend's
               time by stage (pyramid, extrema, orientation, descriptor,
               merge) and the extrema stage by octave and part (contiguous
               copy, kernel, top-k select, cubes + localize) from CUDA
               events
  5. track     the tracking slice, kernel path and plain path: launch
               counts, tracking accepted on every frame, PnP inlier floor,
               pose error against ground truth, BA cost, kernel path
               against plain path; ms per tracked frame, keyframe_step and
               run_ba; frontend frames/s TRACK_CONFIG vs FAST_CONFIG; the
               host syncs inside track_batch
  6. engine    the engine slice, kernel path (engine_programs' graphs,
               captured in an untimed first pass: capture seconds, pool
               bytes, launches per replay) and plain path (eager by
               construction): launch counts, every active frame tracked,
               promotions per batch, the loop database's size, window-BA
               costs, pose errors and ATE against ground truth, kernel
               path against plain path; the graph program against the
               eager run_engine_batch bit for bit on the three batches;
               graph path and eager path in turns: ms per batch, per
               promotion and per tracked frame, host syncs (checked: one
               per active frame), host launch calls, device kernels and
               busy share per batch; frames/s of frontend + engine
  7. sequence  the bench protocol on the kernel path: sequence frames/s
               (median of 3 runs) and frontend frames/s, the time by stage
               (StageTimer), the three runs' trajectories compared bit for
               bit (printed); one timed eager-path run (EagerTracker: the
               engine batch through run_engine_batch) against SEQ_BOUNDS;
               an instrumented kernel-path run: launch counts, host syncs
               per process_stream call and inside every engine batch
               (checked: one per active frame, none per promotion) and
               per two-view init (checked: one, the packed readback; ms
               per call; the first init's solve again on the "ransac"
               program and eagerly, bit for bit, ms and syncs), its
               first two engine batches again through the eager
               run_engine_batch, bit for bit; an untimed plain-path run;
               every frame
               committed, nothing left in flight; tracking-ok share, ATE
               (Sim(3)-aligned), keyframes and inliers against bounds from
               the JAX package on the same features (frames 0..55); kernel
               path against plain path
  8. harris_5pt  the Harris frontend as `cli detect --frontend harris` runs
               it on 16 frames (keypoint floor, unit descriptors,
               frames/s); two-view relative pose of frames 0 and 8 with the
               five-point and the eight-point RANSAC (estimate_relative_pose
               through two_view_from_features), each rotation against
               ground truth under a bound, with its time and host syncs;
               per solver the tracker's "ransac" program and
               two_view_reconstruction_jit against their eager kernel-path
               functions bit for bit (two seeds, the first again), the
               replays' draws against the eager sample_indices, 0 host
               syncs per replay, ms per call of the graph, the eager and
               the plain path, the captures' seconds and bytes, and the
               plain path's rotation under the same bound
  9. reference DEFAULT_CONFIG on frames 8..23: launch counts (4 per
               kernel per detection call), keypoint and match floors,
               kernel path against plain path; extrema_winners bit for bit
               at all 4 octaves and the float32 patch kernels within
               1e-4 * (1 + max |plain|) at octave 0 (752x2496), each timed
               alone and per call beside its bound; frontend frames/s of
               both paths; bench-96's reference row (frames 0..7 through
               process_batch, 6 batches of 16 through process_stream,
               finish), timed once: frames/s, time by stage, host syncs
               per call and the engine's sync rule in every batch that
               did not capture; an
               untimed plain-path run of frames 0..55; frames 0..55 of
               both paths against REF_BOUNDS (half / twice the JAX
               package's Tracker on the same features)
 10. orb       the ORB frontend (FAST_CONFIG with frontend="orb", 8 levels,
               2048 keypoints) on frames 8..23: floors, frames/s, the
               card's features against the CPU port's on frame 8
               (keypoint sets, Hamming distance per coincident keypoint);
               frames 0..55 through process_stream, timed once, with the
               same sync rule, plain-path run and bounds (ORB_BOUNDS)
 11. harness   harness.run_benchmarks on the card (`cli benchmark`): each
               row printed with the card's name, every row finite and
               positive, the three frontend kernels launched (in the SIFT
               row, on their float32 branch) and the opt-in ones not,
               benchmarks/results.json byte for byte as before
 12. full_sequence  kitti_scale.run, benchmarks/kitti_scale.py's protocol
               on the port, not cut: 500 frames of 376x1248 on the loop rectangle (rendered
               in a process pool, untimed), FAST_CONFIG with
               ba.solver="schur_mf"; frames/s over the 492 streamed frames,
               the time by stage, host syncs per process_stream call and
               the engine's sync rule through the closures, the frontend
               kernels' launches, keyframes, loop closures, ATE / RPE;
               the same protocol with EagerTracker (engine_dispatch
               seconds, frames/s, keyframes, closures beside the graph
               path's; the eager engine batch, pose graph and global BA);
               loop_optimize split into the pose-graph program,
               db_correct, the wait for queued device work and host work,
               on both paths; the first closure's padded Sim(3) graph and
               a synthetic 256-node SE(3) graph through their programs
               (optimize_sim3_graph_jit / optimize_pose_graph_jit) and
               eagerly: equal bit for bit, ms per optimize, host launch
               calls, device kernels and busy, 0 host syncs in a replay,
               capture s and bytes; the full-sequence global BA
               (run_ba_jit, schur_mf) cold with its capture and warm (a
               replay of the cold key), equal to the eager run_ba bit for
               bit, with host syncs, launches and segment_sum launches;
               the three BA solvers on that problem, 8 runs each through
               run_ba_jit, equal bit for bit to each other and to the
               eager run_ba in the default mode and against the float64
               dense LM run;
               a checkpoint round trip (bit for
               bit, and the resumed tracker's global BA); the pose file.
               Checked against half / twice the JAX package's figures on
               the same protocol (benchmarks/kitti_scale.json)
 13. parallel  a 4-shard virtual mesh of the one card (and cuda:0..3 too
               where four cards are visible; a virtual mesh runs its
               shards one after another, so its times are no multi-GPU
               scaling figure): parallel/dryrun.run_dryrun(4); the
               data-parallel frontend (FAST_CONFIG, frames 8..23, 4 a
               shard: launch counts, each shard's features bit for bit
               against the one-device frontend on its chunk, the psum'd
               detection count); the matrix-free trajectory-sharded BA
               at C = 1024, L = 4096 against the same solver on one shard
               and the one-device run_ba schur_mf (costs, ms per solve, 0
               host syncs inside the solve); window-size sharded BA
               (landmark psum / ring, trajectory dense) against run_ba;
               Tracker(FAST_CONFIG, mesh) over frames 0..55 for RANSAC
               seeds 0..7 against twice the JAX package's ATE median and
               maximum over the same seeds (PAR_SEQ_BOUNDS) and
               SEQ_BOUNDS' ok share, keyframes and inliers, seed 0 also
               against the one-device tracker with the same synchronous
               window BA; global BA over the mesh on the KITTI-scale
               tracker against the same solver on one shard (cost,
               aligned centres) and the one-device solve (cost, ATE
               against ground truth); pipelined_process
               against chunked detect_batch + process_features, bit for
               bit in the default mode, with frames/s of both
 14. result    one JSON line of per-kernel numbers (the extrema kernels'
               per batch: summed over the 3 octaves, one launch each; the
               others per call at octave 0 or a tracked frame; launches on
               the sequence, the reference sequence, the harness and the
               data-parallel frontend for the three frontend kernels, on
               the main path for segment_sum, sym_eigh and svd3 (the
               sequence's two-view inits, replayed graphs), on the engine
               path for the others), then the last line
               {"ok": true, "device": {...}}

    python3 chip_smoke.py --segment-turns PARENT

takes the segment sum of the checkout at PARENT (another commit's, for
example `git archive <commit> | tar -x -C PARENT`) through its own plan
and wrapper, builds it beside this one, times both alone at every segment
shape set in turns (parent, change, change, parent), sweeps this kernel's
long-segment threshold over 16..256 rows on the power-law set (patched
copies of its kernel and wrapper), and exits after printing both as JSON
lines.

    python3 chip_smoke.py --solver-turns PARENT

takes sym_eigh, svd3 and triangulate_dlt of the checkout at PARENT
through its own wrappers and build, checks them bit for bit against this
checkout's on the init's and the engine's own inputs (sym_eigh at [512,
9, 9], [9, 9], [128, 9, 9] and [1280, 10, 10]; svd3 at the 8-point's
[512, 3, 3] Fs, the [4, 3, 3] refit Fs and essential matrices and the
8-point's essential matrix as [1, 3, 3]; triangulate_dlt at N = 512 and
1024), times them alone and per call in turns (parent, change, change,
parent) beside the chain floor (tests/rotation_chain.cu's rotation
latency: sym_eigh's float64 rotation, the one-test float32 rotation for
svd3 and triangulate_dlt) and torch.linalg's device kernels, and exits
after printing them as a JSON line.

    python3 chip_smoke.py --save-features engine_feats.npz

also writes the engine phase's kernel-path features (numpy), for running
the JAX package's engine on the same features elsewhere;
`--save-sequence-features seq_feats.npz` writes the sequence's features of
frames 0..55 (the tracker's first four detection calls), for the JAX
package's Tracker on the same features (PERF.md);
`--save-reference-features ref_feats.npz` and `--save-orb-features
orb_feats.npz` do the same for the reference and ORB phases
(tests/jax_sequence_bounds.py --profile reference / --frontend orb).

Any failed check raises, so the run exits non-zero and prints no result.
Without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import contextlib
import ctypes
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
import types
import warnings

import numpy as np
import torch
import torch.nn.functional as F

from visualslam_tpu_torch import bench, kitti_scale
from visualslam_tpu_torch.backend.ba import run_ba, run_ba_jit
from visualslam_tpu_torch.backend.pose_graph import resolve_solver
from visualslam_tpu_torch.frontend import SiftFrontend, make_frontend
from visualslam_tpu_torch.geometry import se3
from visualslam_tpu_torch.geometry.camera import normalized
from visualslam_tpu_torch.geometry import ransac as trs
from visualslam_tpu_torch.geometry.ransac import generator
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models import sift
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.pyramid import build_pyramid
from visualslam_tpu_torch.models.sift import (
    _orientation_pass,
    describe_octave,
    merge_octaves,
    octave_result,
    patch_source,
)
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.blur import blur_stack_matmul, pad_symmetric
from visualslam_tpu_torch.ops.cuda import (
    KERNELS,
    PLAIN,
    build,
    launch_counts,
    reset_launch_counts,
)
from visualslam_tpu_torch.ops.cuda import small_linalg as ksl
from visualslam_tpu_torch.ops.cuda import triangulate as ktri
from visualslam_tpu_torch.ops.cuda.descriptor import staged_boxes
from visualslam_tpu_torch.ops.cuda.distance import split_plan
from visualslam_tpu_torch.ops.cuda.extrema import NONE, TILE_H
from visualslam_tpu_torch.ops.cuda.segment import (
    LONG_ROWS,
    segment_plan,
    segment_sum,
    segment_sum_ref,
)
from visualslam_tpu_torch.ops.distance import l2sq_distance_matrix
from visualslam_tpu_torch.ops.extrema import (
    detect_extrema,
    extrema_candidates,
    gather_cubes,
    localize,
)
from visualslam_tpu_torch.ops.patches import crop_patches, patch_shape
from visualslam_tpu_torch.slam import engine
from visualslam_tpu_torch.slam.engine import engine_programs, run_engine_batch
from visualslam_tpu_torch.slam.evaluation import ate_rmse
from visualslam_tpu_torch.slam import tracker as slam_tracker
from visualslam_tpu_torch.slam.two_view import (
    two_view_from_features,
    two_view_from_features_jit,
    two_view_reconstruction,
    two_view_reconstruction_jit,
)
from visualslam_tpu_torch.slam.track_step import keyframe_step, track_batch
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.slam.window import (
    port_ops,
    run_engine,
    run_window,
    world_to_camera,
)
from visualslam_tpu_torch.utils.card import card_name
from visualslam_tpu_torch.utils.config import DEFAULT_CONFIG, FAST_CONFIG
from visualslam_tpu_torch.utils.graphs import GraphProgram, _leaves, _signature
from visualslam_tpu_torch.utils.masked import block_top_k_select
from visualslam_tpu_torch.utils.profiling import StageTimer

H, W, BATCH = 376, 1248, 16
KERNEL_TOL = 1e-4           # x (1 + max |plain|): summation order only
NN_TOL = 1e-5               # x (1 + max |plain|) on valid rows: a.b order
MIN_KEYPOINTS = 800         # per frame
MIN_MATCHES = 250           # per consecutive pair
TRACK_CONFIG = FAST_CONFIG.replace(
    pyramid=FAST_CONFIG.pyramid.replace(blur_mode="pallas"),
    match=FAST_CONFIG.match.replace(impl="pallas"))
# tracking of frames 5..15 after the ground-truth bootstrap of frames 0 and
# 4: half the JAX package's smallest inlier count and twice its largest
# errors, with the same driver on the same frames (PERF.md, CPU rehearsal:
# inliers >= 35, rotation <= 0.2062 deg, position <= 0.1968)
MIN_INLIERS = 17
MAX_ROT_DEG = 0.4124
MAX_POS_ERR = 0.3936        # sequence units; one frame step is 0.4
PATH_ROT_DEG = 0.05         # kernel path vs plain path, per frame
PATH_POS_FRAC = 1e-3        # x the frame 0..15 baseline
PATH_INLIER_FRAC = 0.05
FRONTEND_KERNELS = ("extrema_winners", "orient_hist", "descriptor")
ENGINE_CONFIG = TRACK_CONFIG.replace(
    sift=TRACK_CONFIG.sift.replace(extrema_impl="pallas"))
ENGINE_BATCHES = 3          # frames 0..47
ENGINE_START = 5            # first tracked frame of batch 0
# engine slice over frames 5..47 after the ground-truth bootstrap of frames
# 0 and 4: half the JAX package's smallest inlier count and twice its
# largest errors, with the same driver on the same features (PERF.md, CPU
# rehearsal of the JAX package's run_engine_batch: inliers >= 21, rotation
# <= 0.2339 deg, position <= 1.4567, ATE 0.1344 after a Sim(3) alignment;
# the position error is the monocular scale drift the alignment removes)
ENGINE_MIN_INLIERS = 10
ENGINE_ROT_DEG = 0.4678
ENGINE_POS_ERR = 2.9134     # sequence units; one frame step is 0.4
ENGINE_ATE = 0.2688
ENGINE_PATH_ROT_DEG = 0.05  # kernel path vs plain path, per frame
ENGINE_PATH_POS_FRAC = 1e-3  # x the frame 0..47 baseline
# published H100 SXM peaks (NVIDIA's data sheet): the least time a kernel's
# work could take is the larger of its bytes over the memory rate and its
# operations over the peak rate of the units that run them (f32 on the
# SIMT cores; the 2-NN's 3xTF32 products on the tensor cores)
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12
PEAK_TF32_S = 495e12        # dense, tensor cores
PEAK_F64_S = 34e12          # f64 outside the tensor cores (sym_eigh)
# the part of each kernel's name the profiler reports
DEVICE_NAMES = {"extrema_winners": "extrema_winners_kernel",
                "extrema_score": "extrema_score_kernel",
                "orient_hist": "patch_hist", "descriptor": "patch_hist",
                "blur_stack": "blur", "l2_2nn": "l2_2nn",
                "segment_sum": "segment_sum",
                "triangulate_dlt": "triangulate_kernel",
                "sym_eigh": "sym_eigh_kernel", "svd3": "svd3_kernel"}
SOURCES = {
    "extrema_winners": ("visualslam_tpu_torch/csrc/extrema.cu",
                        "visualslam_tpu/ops/pallas/extrema.py:256"),
    "orient_hist": ("visualslam_tpu_torch/csrc/descriptor.cu",
                    "visualslam_tpu/ops/pallas/descriptor.py:180"),
    "descriptor": ("visualslam_tpu_torch/csrc/descriptor.cu",
                   "visualslam_tpu/ops/pallas/descriptor.py:212"),
    "blur_stack": ("visualslam_tpu_torch/csrc/blur.cu",
                   "visualslam_tpu/ops/pallas/blur.py:115"),
    "l2_2nn": ("visualslam_tpu_torch/csrc/distance.cu",
               "visualslam_tpu/ops/pallas/distance.py:79"),
    "extrema_score": ("visualslam_tpu_torch/csrc/extrema.cu",
                      "visualslam_tpu/ops/pallas/extrema.py:157"),
    # no Pallas kernel: the JAX package's sums are jax.ops.segment_sum
    # (XLA's scatter), first at the BA's normal equations
    "segment_sum": ("visualslam_tpu_torch/csrc/segment.cu",
                    "visualslam_tpu/backend/ba.py:154"),
    # no Pallas kernel: the JAX package's triangulation is jnp.linalg.eigh
    # of the DLT normal matrices
    "triangulate_dlt": ("visualslam_tpu_torch/csrc/triangulate.cu",
                        "visualslam_tpu/geometry/epipolar.py:113"),
    # no Pallas kernel: the JAX package's two-view solvers are
    # jnp.linalg.eigh (the 8-point normal matrices; fivepoint.py:149, 171)
    # and jnp.linalg.svd (the 8-point projection; epipolar.py:123)
    "sym_eigh": ("visualslam_tpu_torch/csrc/small_linalg.cu",
                 "visualslam_tpu/geometry/epipolar.py:66"),
    "svd3": ("visualslam_tpu_torch/csrc/small_linalg.cu",
             "visualslam_tpu/geometry/epipolar.py:71"),
}


def nbytes(*tensors) -> int:
    """Bytes of the tensors among the arguments (nested tuples too)."""
    n = 0
    for t in tensors:
        if isinstance(t, (tuple, list)):
            n += nbytes(*t)
        elif isinstance(t, torch.Tensor):
            n += t.numel() * t.element_size()
    return n


def least_ms(io_bytes: int, ops: float, ops_s: float = PEAK_F32_S) -> tuple:
    """(least ms the card could take, "bytes" or "operations"): each input
    read once and each output written once at PEAK_BYTES_S, the operations
    at `ops_s`."""
    tb, to = io_bytes / PEAK_BYTES_S, ops / ops_s
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: check failed: {what}")


def time_ms(fn, reps: int) -> float:
    """Median device time of fn() in ms over `reps` runs after warmup."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def device_ms(fn, reps: int, kernel: str) -> tuple:
    """(device ms per call of the launches whose name holds `kernel` (every
    launch for None), those launches per call, every device launch per
    call) of fn() over `reps` runs under the profiler: the kernel alone, with no host work of the
    wrapper. Per kernel name, the median launch times the launches per call
    (the profiler may drop an event). (nan, 0, 0) if it saw none."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    every = [e for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict = {}
    for e in every:
        if kernel is None or kernel in e.name:
            by_name.setdefault(e.name, []).append(e.time_range.elapsed_us())
    if not by_name:
        return float("nan"), 0.0, len(every) / reps
    per_call = {n: max(1, round(len(v) / reps)) for n, v in by_name.items()}
    ms = sum(1e-3 * float(np.median(v)) * per_call[n]
             for n, v in by_name.items())
    return ms, float(sum(per_call.values())), round(len(every) / reps, 2)


def kernel_alone(name: str, fn, call_ms: float, what: str = ""):
    """Print and return the kernel-alone device ms of one wrapper call
    (profiler, median launch of 20 calls) beside its CUDA-event call time;
    the profiler now and then records no device event, so up to three
    tries, then None ("not measured")."""
    for _ in range(3):
        ms, mine, every = device_ms(fn, 20, DEVICE_NAMES[name])
        if np.isfinite(ms):
            break
    else:
        print(f"time {name}{what}: kernel alone not measured (the profiler "
              f"recorded no device event in 3 tries), wrapper call "
              f"{call_ms:.4f} ms")
        return None
    print(f"time {name}{what}: kernel alone on the device {ms:.4f} ms "
          f"(profiler, median launch of 20 calls; {mine:g} kernel launches "
          f"and {every:g} device launches per wrapper call), wrapper call "
          f"{call_ms:.4f} ms (CUDA events, host work included)")
    return ms


def wall_ms(fn, reps: int) -> float:
    """Median host-clock ms of fn() + synchronize over `reps` runs after
    one warmup (for calls that read back to the host themselves)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(1e3 * (time.perf_counter() - t0))
    return float(np.median(times))


def frames_of(f: Features, sl: slice) -> Features:
    return Features(Keypoints(*(t[sl] for t in f.keypoints)),
                    f.descriptors[sl])


def frame_pairs(f: Features):
    """(frames 0..B-2, frames 1..B-1) of a batched Features."""
    return frames_of(f, slice(None, -1)), frames_of(f, slice(1, None))


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    card = card_name()
    print(f"device: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0"), card


# latency probes under tests/ that only this script builds
PROBES = ("add_chain", "rotation_chain")


def probe_path(name: str):
    return build.BUILD_DIR / f"lib{name}.so"


def build_probe(name: str) -> None:
    """nvcc tests/<name>.cu into the build directory."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    src = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests",
                       f"{name}.cu")
    proc = subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-o",
                           str(probe_path(name)), src],
                          capture_output=True, text=True)
    check(proc.returncode == 0, f"nvcc builds {src}: {proc.stderr}")


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor

    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=1 + len(PROBES)) as pool:
        jobs = [pool.submit(build.build_all)] + [
            pool.submit(build_probe, name) for name in PROBES]
        for job in jobs:
            job.result()
    for name in build.SOURCES:
        build.load_library(name)
    print(f"build: {time.perf_counter() - t0:.1f} s for "
          f"{len(build.SOURCES)} sources and {len(PROBES)} probes in "
          f"parallel (nvcc {' '.join(build.NVCC_FLAGS[:2])})")
    for name in build.SOURCES:
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}.cu: {line.strip()}")


def render_frames():
    """The benchmark's frames: 48 of the 376x1248 synthetic sequence, as
    uint8 (as bench.py ships them), and the sequence (poses, intrinsics).
    The dolly path's pose k depends on k alone, so frames 0..23 are those
    of a 24-frame sequence."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(num_frames=BATCH * ENGINE_BATCHES, h=H, w=W,
                            n_dots=8000, step=0.4)
    frames = np.stack([seq.frame(k) for k in range(len(seq))])
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    print(f"frames: {frames.shape} uint8 rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    return frames, seq


def _masked_descriptors(f: Features, frames: slice, dev) -> tuple:
    """Descriptors of `frames` as match_features hands them to the 2-NN:
    invalid rows and a seeded ~10% of the valid ones set to 1e3. Returns
    (descriptors [P, K, D], valid rows [P, K])."""
    d = f.descriptors[frames]
    g = torch.Generator().manual_seed(0)
    keep = (torch.rand(d.shape[:2], generator=g) > 0.1).to(dev)
    valid = f.keypoints.valid[frames] & keep
    return (torch.where(valid[..., None], d,
                        torch.full((), 1e3, device=dev)).contiguous(),
            valid)


def check_2nn(a, b, valid, what: str) -> tuple:
    """l2_2nn against its plain version on the valid A rows: best and
    second within NN_TOL x (1 + max |plain|), the index equal off
    near-ties, equal bits run to run. Returns (max error, kernel output)."""
    got = KERNELS.l2_2nn(a, b)
    want = PLAIN.l2_2nn(a, b)
    ref = torch.cat([want[0][valid], want[1][valid]])
    bound = NN_TOL * (1.0 + ref.abs().max().item())
    err = max((got[0] - want[0])[valid].abs().max().item(),
              (got[1] - want[1])[valid].abs().max().item())
    near = valid & ((want[1] - want[0]).abs() <= bound)
    wrong = valid & ~near & (got[2] != want[2])
    print(f"kernel l2_2nn{what}: a {tuple(a.shape)} b {tuple(b.shape)}, "
          f"{int(valid.sum())} valid rows, max |kernel - plain| = "
          f"{err:.3e} (bound {bound:.3e}), {int(near.sum())} near-ties, "
          f"{int(wrong.sum())} other index mismatches")
    check(err <= bound, f"l2_2nn{what} within {NN_TOL} x (1 + max|plain|)")
    check(int(wrong.sum()) == 0, f"l2_2nn{what} indices equal off near-ties")
    check(all(torch.equal(g, h) for g, h in zip(got, KERNELS.l2_2nn(a, b))),
          f"l2_2nn{what}: equal bits run to run")
    return err, got


def kernel_2nn(feats: Features, dev) -> tuple:
    """l2_2nn against its plain version on a tracked frame's problem,
    [1, 2048, 128] x [1, 2048, 128] from the slice's descriptors, and on
    the batch's 15 consecutive pairs."""
    a, va = _masked_descriptors(feats, slice(0, 1), dev)
    b, _ = _masked_descriptors(feats, slice(1, 2), dev)
    err, got = check_2nn(a, b, va, "")
    ms = time_ms(lambda: KERNELS.l2_2nn(a, b), 20)
    plain_ms = time_ms(lambda: PLAIN.l2_2nn(a, b), 20)
    kernel_ms = kernel_alone("l2_2nn", lambda: KERNELS.l2_2nn(a, b), ms)
    P, Ka, D = a.shape
    # the kernel's route: three TF32 products per a.b on the tensor cores
    bms, by = least_ms(nbytes(a, b, got), 3 * 2.0 * P * Ka * b.shape[1] * D,
                       PEAK_TF32_S)
    a15, va15 = _masked_descriptors(feats, slice(0, BATCH - 1), dev)
    b15, _ = _masked_descriptors(feats, slice(1, BATCH), dev)
    _, got15 = check_2nn(a15, b15, va15, " 15 pairs")
    b15ms, _ = least_ms(nbytes(a15, b15, got15),
                        3 * 2.0 * a15.shape[0] * Ka * b15.shape[1] * D,
                        PEAK_TF32_S)
    ms15 = time_ms(lambda: KERNELS.l2_2nn(a15, b15), 10)
    print(f"time l2_2nn 15 pairs {tuple(a15.shape)}: kernel {ms15:.4f} ms, "
          f"plain {time_ms(lambda: PLAIN.l2_2nn(a15, b15), 10):.4f} ms, "
          f"bound {b15ms:.4f} ms (3xTF32 products at the TF32 rate)")
    kernel_alone("l2_2nn", lambda: KERNELS.l2_2nn(a15, b15), ms15,
                 " 15 pairs")
    # aside: one f32 product per a.b on the SIMT cores (the earlier route)
    f32 = [1e3 * 2.0 * x.shape[0] * Ka * b.shape[1] * D / PEAK_F32_S
           for x in (a, a15)]
    nsplit, _, per_sm = split_plan(a, b)
    print(f"l2_2nn f32 SIMT floor (aside, not the bound): {f32[0]:.4f} ms at "
          f"[1, 2048, 128]^2, {f32[1]:.4f} ms on 15 pairs; {per_sm} blocks "
          f"per SM (the build's occupancy), {nsplit} splits at P = 1, "
          f"{split_plan(a15, b15)[0]} on 15 pairs")
    # the library yardstick: FAST_CONFIG's own dense matcher, the distance
    # matrix by one product, then the two smallest per row
    library_ms = time_ms(lambda: torch.topk(l2sq_distance_matrix(a, b), 2,
                                            largest=False), 20)
    return dict(err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms)


# the rotation chains of tests/rotation_chain.cu: sym_eigh's float64
# formulas and the float32 kernels' own rotations (csrc/jacobi_f32.cuh:
# triangulate_dlt's stand-ins, svd3's one test). The float32 chain floors
# are taken at the fastest of them that keeps the bits, the one test
# (PERF.md); triangulate_dlt's own chain is printed beside its floor
ROTATION_PROBES = {"f64": (torch.float64, "rotation_chain_f64"),
                   "f32_stand_ins": (torch.float32,
                                     "rotation_chain_f32_stand_ins"),
                   "f32_one_test": (torch.float32,
                                    "rotation_chain_f32_one_test")}


def rotation_latency(dev) -> dict:
    """The latency of one Jacobi rotation's dependent chain on the card, per
    probe of ROTATION_PROBES: one thread carries out 2^16 rotations in a
    row, each pivot the row update of the last (tests/rotation_chain.cu).
    Cycles per rotation from the SM's clock counter, ns per rotation from
    CUDA events around the launch. A matrix's Jacobi goes no faster than
    its rotations times the ns per rotation: its chain floor."""
    lib = ctypes.CDLL(str(probe_path("rotation_chain")))
    n = 1 << 16
    out = {}
    card = card_name()
    for name, (dtype, symbol) in ROTATION_PROBES.items():
        fn = getattr(lib, symbol)
        fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p]
        x = torch.tensor([0.3, 1.7, 0.5, 0.9], dtype=dtype, device=dev)
        res = torch.empty(1, dtype=dtype, device=dev)
        cycles = torch.empty(1, dtype=torch.int64, device=dev)
        for reps in (64, n):                  # the first warms the launch
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            rc = fn(x.data_ptr(), reps, res.data_ptr(), cycles.data_ptr(),
                    build.stream_handle(dev))
            end.record()
            build.check_launch(rc, "rotation_chain")
            end.synchronize()
        out[name] = ns = start.elapsed_time(end) * 1e6 / n
        print(f"rotation latency {name} ({symbol}, {card}): "
              f"{int(cycles.item()) / n:.1f} cycles per dependent rotation "
              f"(SM clock counter), {ns:.2f} ns (CUDA events)")
    return out


@contextlib.contextmanager
def counted_rotations(batch: int):
    """Per matrix, the rotations small_linalg's replays carry out while the
    block runs (a zero pivot is skipped): yields the counts [batch]."""
    counts = torch.zeros(batch, dtype=torch.int64)
    real = ksl._rotate

    def counting(a, v, p, q, rn):
        counts.add_((a[:, p, q] != 0).long())
        return real(a, v, p, q, rn)

    ksl._rotate = counting
    try:
        yield counts
    finally:
        ksl._rotate = real


# the rotations of the longest point's chain: every pivot counted
TRI_ROTATIONS = ktri.SWEEPS * len(ktri.PAIRS)


# floating-point operations per point of csrc/triangulate.cu: the DLT rows
# (16 products, 16 differences), the 10 entries of A^T A (4 products, 3
# sums each), SWEEPS x 6 rotations of 66 (the rotation's angle 16, the
# diagonal 2, the two other rows of the pair 16, the four rows of V 32; a
# square root or a quotient counted as one), the selection (3), the sign
# and the three quotients (4)
TRI_FLOPS = 32 + 70 + ktri.SWEEPS * len(ktri.PAIRS) * 66 + 7


def triangulation_inputs(feats: Features, seq, a: int, b: int, cfg, dev):
    """What keyframe_step hands the triangulation for keyframe a and frame
    b of the batch (frames 8 + a, 8 + b of the sequence): the match slots
    (cfg.match.max_matches of them, invalid ones included) as normalized
    coordinates and the ground-truth relative pose."""
    fa, fb = (Features(Keypoints(*(x[k] for x in feats.keypoints)),
                       feats.descriptors[k]) for k in (a, b))
    m = match_features(fa, fb, cfg.match)
    intr = torch.tensor(seq.intrinsics, device=dev)
    x1 = normalized(fa.keypoints.yx[m.idx_a.long()].flip(-1), intr)
    x2 = normalized(fb.keypoints.yx[m.idx_b.long()].flip(-1), intr)
    R_gt, t_gt = world_to_camera(seq.gt_poses[8 + a:9 + b])
    Rw = torch.tensor(R_gt, device=dev)
    tw = torch.tensor(t_gt, device=dev)
    R, t = se3.compose(Rw[-1], tw[-1], *se3.inverse(Rw[0], tw[0]))
    return R.contiguous(), t.contiguous(), x1, x2, m.valid


def kernel_triangulate(feats: Features, seq, dev, lat: dict) -> dict:
    """triangulate_dlt at the engine's shapes (ENGINE_CONFIG's 1024 match
    slots; keyframe 8, frame 12, the bootstrap's spacing): bit for bit
    against its float32 replay on the CPU (ops/cuda/triangulate.py
    triangulate_jacobi), equal run to run, and against the plain version
    (cuSOLVER eigh) under the eigengap gate stated there; the replay's
    off-diagonal norms after each sweep; times beside the bound, the plain
    version and torch.linalg.eigh of the same normal matrices, and the
    chain floor (TRI_ROTATIONS x the one-test float32 rotation latency in
    `lat`) beside the chain of the kernel's own rotation (the stand-ins)."""
    R, t, x1, x2, valid = triangulation_inputs(feats, seq, 0, 4,
                                               ENGINE_CONFIG, dev)
    n = x1.shape[0]
    got = KERNELS.triangulate_dlt(R, t, x1, x2)
    check(torch.equal(got, KERNELS.triangulate_dlt(R, t, x1, x2)),
          "triangulate_dlt: equal bits run to run")
    cpu = [x.cpu() for x in (R, t, x1, x2)]
    offs = []
    rep, v = ktri.triangulate_jacobi(*cpu, offs=offs, vectors=True)
    same = torch.equal(got.cpu(), rep)
    gap = ktri.eigen_gap(ktri.normal_matrices(*cpu).numpy())
    ref_v = ktri.unit_vectors_ref(R, t, x1, x2).cpu().numpy()
    compared, worst, bound = ktri.compare_solvers(v.numpy(), ref_v, gap)
    plain = PLAIN.triangulate_dlt(R, t, x1, x2)
    gate = torch.from_numpy((gap >= ktri.GAP_MIN)
                            & (np.abs(ref_v[:, 3]) > 1e-3)).to(dev)
    err = float((got - plain)[gate].abs().max()) if gate.any() else 0.0
    print(f"kernel triangulate_dlt: {n} points ({int(valid.sum())} valid "
          f"matches), equal to its float32 replay bit for bit: {same}; "
          f"against the plain version (cuSOLVER eigh): {compared} points "
          f"at relative eigengaps >= {ktri.GAP_MIN}, worst |dv| x gap / "
          f"eps32 = {worst:.3f} (bound {bound}); max |kernel - plain| "
          f"{err:.4e} over the {int(gate.sum())} of them with |w| > 1e-3")
    print(f"triangulate_dlt sweeps: largest relative off-diagonal norm "
          f"after each of {ktri.SWEEPS}: "
          f"{[f'{float(o.max()):.3e}' for o in offs]} (float32 epsilon "
          f"{ktri.EPS32:.3e})")
    check(same, "triangulate_dlt equals its float32 replay bit for bit")
    check(compared > 0.25 * n and worst <= bound, "triangulate_dlt holds to "
          "the plain version under the eigengap gate")
    check(float(offs[ktri.SWEEPS - 2].max()) < ktri.EPS32,
          "triangulate_dlt's off-diagonal norms below float32 rounding "
          "before its last sweep")
    ms = time_ms(lambda: KERNELS.triangulate_dlt(R, t, x1, x2), 20)
    plain_ms = time_ms(lambda: PLAIN.triangulate_dlt(R, t, x1, x2), 20)
    kernel_ms = kernel_alone("triangulate_dlt",
                             lambda: KERNELS.triangulate_dlt(R, t, x1, x2),
                             ms)
    M = ktri.normal_matrices(R, t, x1, x2)
    library_ms = time_ms(lambda: torch.linalg.eigh(M), 20)
    bms, by = least_ms(nbytes(R, t, x1, x2, got), float(TRI_FLOPS) * n)
    chain_ms = TRI_ROTATIONS * lat["f32_one_test"] * 1e-6
    own_ms = TRI_ROTATIONS * lat["f32_stand_ins"] * 1e-6
    alone = ("not measured" if kernel_ms is None else f"{kernel_ms:.4f} ms")
    print(f"time triangulate_dlt N = {n}: kernel alone {alone}, "
          f"bound {bms:.6f} ms ({by}), chain floor {chain_ms:.6f} ms "
          f"({TRI_ROTATIONS} dependent float32 rotations a point, every "
          f"pivot counted, at the one test's {lat['f32_one_test']:.2f} ns; "
          f"the kernel's own stand-ins chain {own_ms:.6f} ms at "
          f"{lat['f32_stand_ins']:.2f} ns)")
    return dict(err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=library_ms)


# operations of csrc/small_linalg.cu: a Jacobi rotation of an n x n matrix
# 16 n + 2 (its angle 16, the diagonal 2, the n - 2 other rows of the pair
# 8 each, the n rows of V 8 each; a square root or a quotient counted as
# one), counted over the rotations the data needs (a zero pivot is
# skipped); svd3 adds per matrix A^T A (30), A v (45), the three norms
# (18), u_1 and u_2 (6), the cross product (9) and its side (5); sym_eigh's
# at the card's float64 rate, svd3's at its float32 rate
SVD3_FLOPS = 30 + 45 + 18 + 6 + 9 + 5
TWO_VIEW_SOLVERS = (("8pt", 512), ("5pt", 128))


def two_view_config(solver: str, n: int):
    """FAST_CONFIG with the two-view check's RANSAC: `solver`, n
    hypotheses, the Sampson threshold TWO_VIEW_SAMPSON."""
    return FAST_CONFIG.replace(ransac=FAST_CONFIG.ransac.replace(
        solver=solver, num_hypotheses=n, inlier_threshold=TWO_VIEW_SAMPSON))


def two_view_pair(frames_dev: torch.Tensor, frontend: SiftFrontend, seq,
                  dev) -> tuple:
    """FAST_CONFIG's features of frames 0 and 8, the intrinsics and the
    ground-truth relative rotation."""
    f = frontend(frames_dev[[0, 8]])
    fa, fb = (Features(Keypoints(*(x[i] for x in f.keypoints)),
                       f.descriptors[i]) for i in range(2))
    R_gt, _ = world_to_camera(seq.gt_poses[[0, 8]])
    return fa, fb, torch.tensor(seq.intrinsics, device=dev), \
        R_gt[1] @ R_gt[0].T


def init_matrices(fa, fb, intr, dev) -> dict:
    """The inputs each two-view init hands sym_eigh and svd3 (frames 0 ->
    8, per solver of TWO_VIEW_SOLVERS): two_view_from_features run eagerly
    with the kernels wrapped to keep them."""
    out = {}
    for solver, n in TWO_VIEW_SOLVERS:
        calls = {"sym_eigh": [], "svd3": []}

        def keep(name):
            fn = getattr(KERNELS, name)

            def wrapped(x):
                calls[name].append(x.clone())
                return fn(x)
            return wrapped

        cfg = two_view_config(solver, n)
        two_view_from_features(fa, fb, intr, cfg,
                               generator(cfg.ransac.seed, dev),
                               KERNELS._replace(sym_eigh=keep("sym_eigh"),
                                                svd3=keep("svd3")))
        out[solver] = calls
    return out


def check_small_linalg(name: str, x: torch.Tensor, what: str) -> dict:
    """One batch of sym_eigh or svd3 on the card against its replay on
    the CPU (bit for bit), run to run, and the plain version
    (eigenvalues within EIG_TOL, eigenvector clusters within VEC_TOL x
    eps32 / gap); the replay's off-diagonal norm per sweep, which must lie
    below float32 epsilon before the last sweep. Returns the kernel's outputs, the
    comparison, the rotations the replay carried out (in all, and for the
    matrix that needed most) and the norms."""
    fn, replay, plain, compare = {
        "sym_eigh": (ksl.sym_eigh, ksl.sym_eigh_jacobi, ksl.sym_eigh_ref,
                     ksl.compare_eigh),
        "svd3": (ksl.svd3, ksl.svd3_jacobi, ksl.svd3_ref,
                 ksl.compare_svd3)}[name]
    got = fn(x)
    offs, done = [], []
    n = x.shape[-1]
    with counted_rotations(x.numel() // (n * n)) as per_matrix:
        want = replay(x.cpu(), offs=offs, done=done)
    same = all(torch.equal(g.cpu(), w) for g, w in zip(got, want))
    again = all(torch.equal(a, b) for a, b in zip(fn(x), got))
    ref = plain(x)
    r = compare(*(g.cpu() for g in got), *(p.cpu() for p in ref))
    values = 0 if name == "sym_eigh" else 1
    abs_err = float((got[values] - ref[values]).abs().max())
    worst = [float(o.max()) for o in offs]
    print(f"kernel {name} {what} {tuple(x.shape)}: equal to its replay "
          f"bit for bit {same}, run to run {again}; against the "
          f"plain version (cuSOLVER): values apart by {abs_err:.3e}, "
          f"within {r['val_err']:.3e} x "
          f"max (bound {r['val_tol']}), {r['compared']} eigenvector "
          f"clusters at relative gaps >= {ktri.GAP_MIN}, worst |dP| x gap "
          f"/ eps32 {r['worst']:.3f} (bound {r['bound']}); off-diagonal "
          f"norm before and after each sweep {[f'{w:.2e}' for w in worst]},"
          f" rotations per sweep {done}")
    check(same and again, f"{name} {what}: equal to its replay bit for bit "
          "and run to run")
    check(r["val_err"] <= r["val_tol"] and r["worst"] <= r["bound"],
          f"{name} {what}: within the eigengap-gated tolerances of the "
          "plain version")
    check(worst[-2] < ktri.EPS32, f"{name} {what}: the off-diagonal norm "
          "below float32 rounding before the last sweep")
    return dict(got=got, cmp=r, abs_err=abs_err, rotations=sum(done),
                longest=int(per_matrix.max()), offs=worst)


def kernel_small_linalg(frames_dev: torch.Tensor, frontend: SiftFrontend,
                        seq, dev, lat: dict) -> dict:
    """sym_eigh and svd3 on the two-view init's own matrices (frames 0 ->
    8): the 8-point's 512 normal matrices and its refit, the five-point's
    128 9x9 nullspace systems and 1280 10x10 systems, the 512 Fs of the
    8-point projection and the pose decompositions, each checked by
    check_small_linalg; the main path's batches (8-point) timed per call,
    alone, beside the bound, the plain version and torch.linalg.eigh / svd
    with its status read (host clock) and without it (its device kernels
    alone, profiler), and the chain floor (the rotations of the matrix
    that needs most x the rotation latency `lat`: float64 for sym_eigh,
    float32 for svd3)."""
    t0 = time.perf_counter()
    fa, fb, intr, _ = two_view_pair(frames_dev, frontend, seq, dev)
    mats = init_matrices(fa, fb, intr, dev)
    e8, e5 = mats["8pt"]["sym_eigh"], mats["5pt"]["sym_eigh"]
    batches = {
        "sym_eigh": [(e8[0], "8-point normal matrices"),
                     (e8[1], "8-point refit"),
                     (e5[0], "five-point nullspace systems"),
                     (e5[1].reshape(-1, 10, 10), "five-point 10x10 systems")],
        "svd3": [(mats["8pt"]["svd3"][0], "8-point F"),
                 (torch.stack([x.reshape(3, 3) for k in ("8pt", "5pt")
                               for x in mats[k]["svd3"][-2:]]),
                  "refit F and essential matrices")]}
    out = {}
    for name, todo in batches.items():
        res = [check_small_linalg(name, x, what) for x, what in todo]
        x, r = todo[0][0], res[0]
        ms = time_ms(lambda: getattr(KERNELS, name)(x), 20)
        plain = getattr(PLAIN, name)
        plain_ms = time_ms(lambda: plain(x), 20)
        kernel_ms = kernel_alone(name, lambda: getattr(KERNELS, name)(x), ms,
                                 f" {tuple(x.shape)}")
        lib = torch.linalg.eigh if name == "sym_eigh" else torch.linalg.svd
        library_ms = wall_ms(lambda: lib(x), 20)
        lib_dev, lib_launches, _ = device_ms(lambda: lib(x), 20, None)
        n = x.shape[-1]
        flops = (r["rotations"] * (16 * n + 2) if name == "sym_eigh" else
                 r["rotations"] * (16 * 3 + 2) + SVD3_FLOPS * x.shape[0])
        rate = PEAK_F64_S if name == "sym_eigh" else PEAK_F32_S
        bms, by = least_ms(nbytes(x, r["got"]), float(flops), rate)
        b32, _ = least_ms(nbytes(x, r["got"]), float(flops), PEAK_F32_S)
        ns = lat["f64" if name == "sym_eigh" else "f32_one_test"]
        chain_ms = r["longest"] * ns * 1e-6
        print(f"time {name} {tuple(x.shape)}: kernel call {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms (CUDA events), bound {bms:.6f} ms "
              f"({by}: {flops} flop over the rotations this batch needs, "
              f"at {rate / 1e12:g} TFLOP/s; at the float32 rate of the "
              f"function's float32 contract {b32:.6f} ms; "
              f"{nbytes(x, r['got'])} bytes), chain floor {chain_ms:.6f} "
              f"ms ({r['longest']} dependent rotations in the longest "
              f"matrix at {ns:.2f} ns), torch.linalg "
              f"{library_ms:.4f} ms per call with its status read (host "
              f"clock), {lib_dev:.4f} ms of device kernels without it "
              f"({lib_launches:g} launches, profiler)")
        out[name] = dict(err=r["abs_err"], ms=ms,
                         kernel_ms=kernel_ms, plain_ms=plain_ms,
                         bound_ms=bms, bound_by=by, library_ms=library_ms)
    print(f"small_linalg kernels wall time: {time.perf_counter() - t0:.1f} s")
    return out


def kernel_blur(batch: torch.Tensor, frontend: SiftFrontend, dev) -> tuple:
    """blur_stack against its plain version at octave 0 of a batch, timed
    beside the port's banded-matmul blur on the same input."""
    img = batch.float() * (1.0 / 255.0)                 # [16, 376, 1248]
    taps = frontend.bands.taps(dev)
    got = KERNELS.blur_stack(img, taps)
    want = PLAIN.blur_stack(img, taps)
    check(bool(torch.isfinite(got).all()), "blur_stack output is finite")
    err = (got - want).abs().max().item()
    mm = blur_stack_matmul(img, frontend.bands)
    print(f"kernel blur_stack: img {tuple(img.shape)}, taps "
          f"{tuple(taps.shape)}, max |kernel - plain| = {err:.3e}, max "
          f"|kernel - matmul blur| = {(got - mm).abs().max().item():.3e}")
    # the same taps in the same order, a rounded product and a rounded add
    # per tap: the same bits
    check(torch.equal(got, want), "blur_stack equals its plain version")
    ms = time_ms(lambda: KERNELS.blur_stack(img, taps), 20)
    plain_ms = time_ms(lambda: PLAIN.blur_stack(img, taps), 5)
    kernel_ms = kernel_alone("blur_stack",
                             lambda: KERNELS.blur_stack(img, taps), ms)
    mm_ms = time_ms(lambda: blur_stack_matmul(img, frontend.bands), 20)
    # the library yardstick: one cuDNN convolution (TF32 off) of the
    # symmetric-padded frames with each sigma's 2-D outer-product kernel
    S, K = taps.shape
    R = (K - 1) // 2
    padded = pad_symmetric(pad_symmetric(img[:, None], 2, R), 3, R)
    kern2d = (taps[:, :, None] * taps[:, None, :])[:, None].contiguous()
    lib = F.conv2d(padded, kern2d)
    lib_err = (lib - want).abs().max().item()
    lib_ms = time_ms(lambda: F.conv2d(padded, kern2d), 5)
    # the work: a multiply and an add per non-zero tap, per sigma, per
    # pass, per pixel; each input read once, the output written once
    ops = 2.0 * 2.0 * int((taps != 0).sum()) * img.numel()
    io = nbytes(img, taps, got)
    bms, by = least_ms(io, ops)
    print(f"time blur at octave 0: kernel {ms:.4f} ms, plain {plain_ms:.4f} "
          f"ms, blur_stack_matmul {mm_ms:.4f} ms, F.conv2d {lib_ms:.4f} ms "
          f"(max |conv2d - plain| {lib_err:.3e}), bound {bms:.4f} ms ({by}; "
          f"a tap as one FMA), no-FMA floor {2e3 * ops / PEAK_F32_S:.4f} ms "
          f"(a separate multiply and add per tap, as the plain version "
          f"rounds), bytes floor {1e3 * io / PEAK_BYTES_S:.4f} ms "
          f"({io / 1e6:.1f} MB)")
    return dict(err=err, ms=ms, kernel_ms=kernel_ms, plain_ms=plain_ms,
                bound_ms=bms, bound_by=by, library_ms=lib_ms)


EXTREMA_KERNELS = ("extrema_winners", "extrema_score")


def kernel_extrema(ss, thr: float, cap: int,
                   names: tuple = EXTREMA_KERNELS) -> dict:
    """The extrema kernels `names` against their plain versions at every
    octave of a pyramid, bit for bit and equal run to run (the fused
    candidates that follow too, at octave 0): each octave's call, alone and
    bound times, and the batch's figure, their sum over the octaves (one
    launch per octave)."""
    per_oct = {name: [] for name in names}
    for o, dog in enumerate(ss.dog):
        dog = dog.contiguous()
        B, D, Hd, Wd = dog.shape
        # ~28 operations (26 compares, |.|, the pre-filter) per inner position
        scan_ops = 28.0 * B * (D - 2) * Hd * Wd
        for name in names:
            kfn, pfn = getattr(KERNELS, name), getattr(PLAIN, name)
            # the winners are a pair of planes, the score map one
            got, want, again = (r if isinstance(r, tuple) else (r,)
                                for r in (kfn(dog, thr), pfn(dog, thr),
                                          kfn(dog, thr)))
            check(all(map(torch.equal, got, want)),
                  f"{name} at octave {o} equals its plain version bit for bit")
            check(all(map(torch.equal, got, again)),
                  f"{name} at octave {o}: equal bits run to run")
            if name == "extrema_winners" and o == 0:
                cand_k = extrema_candidates(dog, thr, cap, KERNELS)
                cand_p = extrema_candidates(dog, thr, cap, PLAIN)
                for i, what in ((0, "lvl"), (1, "y"), (2, "x"), (4, "sel")):
                    check(torch.equal(cand_k[i], cand_p[i]),
                          f"extrema candidates' {what} equal bit for bit")
            what = f" octave {o} {tuple(dog.shape)}"
            ms = time_ms(lambda: kfn(dog, thr), 20)
            r = dict(err=max((g - w).abs().max().item()
                             for g, w in zip(got, want)),
                     ms=ms, plain_ms=time_ms(lambda: pfn(dog, thr), 5),
                     kernel_ms=kernel_alone(name, lambda: kfn(dog, thr), ms,
                                            what))
            r.update(zip(("bound_ms", "bound_by"),
                         least_ms(nbytes(dog, got), scan_ops)))
            per_oct[name].append(r)
            alone = ("not measured" if r["kernel_ms"] is None
                     else f"{r['kernel_ms']:.4f} ms")
            print(f"kernel {name}{what}: bit-exact, kernel alone {alone}, "
                  f"call {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, "
                  f"bound {r['bound_ms']:.4f} ms ({r['bound_by']})")
            del got, want, again
    out = {}
    for name, rows in per_oct.items():
        alone = [r["kernel_ms"] for r in rows]
        out[name] = dict(
            err=max(r["err"] for r in rows),
            kernel_ms=None if None in alone else sum(alone),
            library_ms=None, bound_by=rows[0]["bound_by"],
            **{k: sum(r[k] for r in rows)
               for k in ("ms", "plain_ms", "bound_ms")})
        r = out[name]
        alone = ("not measured" if r["kernel_ms"] is None
                 else f"{r['kernel_ms']:.4f} ms")
        print(f"time {name} per batch ({len(rows)} octaves, one launch "
              f"each): kernel alone {alone}, call {r['ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms; by octave alone "
              + ", ".join("not measured" if a is None else f"{a:.4f}"
                          for a in (q["kernel_ms"] for q in rows))
              + " ms, call " + ", ".join(f"{q['ms']:.4f}" for q in rows)
              + " ms, bound "
              + ", ".join(f"{q['bound_ms']:.4f}" for q in rows) + " ms")
    return out


def kernel_patches(ss, cfg, dev) -> dict:
    """The two patch kernels against their plain versions at octave 0 of a
    pyramid under `cfg` (bf16 patches of 32 rows under FAST_CONFIG, float32
    of 28 under DEFAULT_CONFIG): within KERNEL_TOL x (1 + max |plain|) and
    equal run to run, the descriptor on the keypoints spawned from the
    candidates; each kernel's call, alone, plain and bound times, and the
    time of the gathers the kernel path no longer runs."""
    cap = cfg.sift.octave_capacity(0)
    dog = ss.dog[0].contiguous()
    B = dog.shape[0]
    out = {}
    # the frontend's octave-0 patch stages; the descriptor on the keypoints
    # spawned from them, each at its candidate's origin
    lvl, y, x, offset, resp, valid = detect_extrema(dog, cfg.sift, cap,
                                                    KERNELS)
    src = patch_source(ss, 0, lvl, y, x, cfg.sift)
    kps, cand_idx = _orientation_pass(src, lvl, y, x, offset, resp, valid,
                                      cfg.pyramid, cfg.sift, PLAIN)
    yx = torch.stack([y, x], -1).float()
    lvl_f = (lvl.float() + offset[..., 0]).flatten()
    sigma = (cfg.sift.orientation_sigma_scale * cfg.pyramid.base_sigma
             * cfg.pyramid.k_factor ** lvl_f).contiguous()
    every = torch.arange(cap, device=dev).expand(B, cap)
    yxf = kps.yx_oct.flatten(0, 1).contiguous()
    angle = kps.orientation.flatten().contiguous()
    levels = (src.mag, src.ori)
    _, _, Hl, Wl = src.mag.shape
    ph, pw = patch_shape(Hl, Wl, src.patch)
    for name, idx, centre, per_kp, box_angle in (
            ("orient_hist", every, yx.flatten(0, 1), sigma, None),
            ("descriptor", cand_idx, yxf, angle, angle)):
        kidx = src.at(idx)
        args = levels + kidx + (centre, per_kp, src.patch, src.bf16)
        kfn, pfn = getattr(KERNELS, name), getattr(PLAIN, name)
        got, want = kfn(*args), pfn(*args)
        check(bool(torch.isfinite(got).all()), f"{name} output is finite")
        check(torch.equal(got, kfn(*args)), f"{name}: equal bits run to run")
        err = (got - want).abs().max().item()
        tol = KERNEL_TOL * (1.0 + want.abs().max().item())
        # the bytes this function needs: each keypoint's box of level
        # samples its weighted taps cover, both f32 channels, read once;
        # its scalars read once; its histogram written once
        _, _, nr, nc = staged_boxes(centre, kidx[2], kidx[3], box_angle,
                                    ph, pw)
        box_bytes = 2 * 4 * int((nr * nc).sum())
        io = box_bytes + nbytes(kidx, centre, per_kp, got)
        # ~40 operations per sample: 4 taps x 2 channels, the weights, the
        # exponential, three tent bins
        ops = 40.0 * 256 * centre.shape[0]
        print(f"kernel {name}: levels {tuple(src.mag.shape)} x 2 f32, "
              f"K = {centre.shape[0]}, bf16 {src.bf16}, ph {ph}, max "
              f"|kernel - plain| = {err:.3e} (bound {tol:.3e}), boxes "
              f"{box_bytes / 1e6:.1f} MB (mean {float((nr * nc).float().mean()):.1f} "
              f"samples)")
        check(err <= tol, f"{name} within {KERNEL_TOL} x (1 + max|plain|)")
        out[name] = dict(err=err, ms=time_ms(lambda: kfn(*args), 20),
                         plain_ms=time_ms(lambda: pfn(*args), 5),
                         library_ms=None)
        out[name].update(zip(("bound_ms", "bound_by"), least_ms(io, ops)))
        out[name]["kernel_ms"] = kernel_alone(name, lambda: kfn(*args),
                                              out[name]["ms"])

    # what the kernel path no longer does: stack, cast, pad + crop, and the
    # re-gather of the patches by candidate
    def removed_gathers():
        stack = torch.stack([src.mag, src.ori], 1)
        if src.bf16:
            stack = stack.to(torch.bfloat16)
        patches, _, _ = crop_patches(stack, src.glvl, yx, src.patch)
        return sift._take(patches, cand_idx)

    gather_ms = time_ms(removed_gathers, 10)
    print(f"time removed gathers at octave 0 (stack{' + bf16 cast' * src.bf16}"
          f" + crop_patches + re-gather by candidate, "
          f"{tuple(removed_gathers().shape)}): {gather_ms:.4f} ms "
          f"against orient_hist + descriptor "
          f"{out['orient_hist']['ms'] + out['descriptor']['ms']:.4f} ms")
    return out


def segment_sets(name: str) -> list:
    """The segment sums' index arrays at the main paths' shapes (numpy):
    [(what, idx [O], n, widths)]. global_ba: the KITTI-scale global BA
    (C = 67, L = 6007, O = 27420; cameras in ascending runs, as
    build_global_problem lays them out): U / bc and the matvec's camera
    sums, V / bl and its landmark sums, the dense solvers' pair sum;
    window_grid: engine._window_ba's [Kl, W] = [2048, 10] observation
    grid; pose_graph: the 256-node padded graph's 1024 edges (padding on
    node 0), D = 6 and 7, and the dense solve's N * N block index;
    one_long: one segment of 100000 rows; power_law: 4096 segments of
    power-law lengths (2 to 20000 rows, 84 of them long), rows shuffled,
    widths 1 to 300."""
    r = np.random.default_rng(12)
    if name == "global_ba":
        C, L, O = 67, 6007, 27420
        cam = np.sort(r.integers(0, C, O))
        lm = r.integers(0, L, O)
        return [("cam", cam, C, (36, 6)), ("lm", lm, L, (9, 3)),
                ("pair", cam * L + lm, C * L, (18,))]
    if name == "window_grid":
        Kl, Wn = 2048, 10
        o = np.arange(Kl * Wn)
        cam, lm = o % Wn, o // Wn
        return [("cam", cam, Wn, (36, 6)), ("lm", lm, Kl, (9, 3)),
                ("pair", cam * Kl + lm, Wn * Kl, (18,))]
    if name == "one_long":
        return [("one", np.zeros(100_000, np.int64), 1, (1, 6))]
    if name == "power_law":
        r = np.random.default_rng(5)
        lengths = np.minimum((r.pareto(1.1, 4096) + 1) * 2,
                             20000).astype(np.int64)
        idx = np.repeat(np.arange(4096), lengths)
        r.shuffle(idx)
        return [("mix", idx, 4096, (1, 6, 36, 300))]
    N, E, ne = 256, 1024, 300
    i = np.zeros(E, np.int64)
    j = np.zeros(E, np.int64)
    i[:ne] = r.integers(0, N, ne)
    j[:ne] = r.integers(0, N, ne)
    return [("i", i, N, (6, 7, 36, 49)), ("j", j, N, (6, 7, 36, 49)),
            ("ij", i * N + j, N * N, (36, 49))]


SEGMENT_SETS = ("global_ba", "window_grid", "pose_graph", "one_long",
                "power_law")
# the kernels line's segment_sum row: the CG matvec's camera sum of the
# global BA ([27420, 6] -> [67, 6]), its most frequent call
SEGMENT_ROW = ("global_ba", "cam", 6)
# the shapes a CUDA graph captures the sum at: the window BA's and the
# pose graph's
SEGMENT_GRAPHED = (("window_grid", "cam"), ("window_grid", "lm"),
                   ("pose_graph", "i"))


def add_chain(lib, dtype: torch.dtype, n: int, dev) -> tuple:
    """One thread on the card adds a value to itself n times (n a multiple
    of 64), each add waiting on the last (tests/add_chain.cu): (SM cycles
    the chain took, ms between CUDA events around the launch)."""
    v = torch.ones(1, dtype=dtype, device=dev)
    out = torch.empty(1, dtype=dtype, device=dev)
    cycles = torch.empty(1, dtype=torch.int64, device=dev)
    fn = getattr(lib, "add_chain_f32" if dtype == torch.float32
                 else "add_chain_f64")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    rc = fn(v.data_ptr(), n, out.data_ptr(), cycles.data_ptr(),
            build.stream_handle(v.device))
    end.record()
    build.check_launch(rc, "add_chain")
    end.synchronize()
    return int(cycles.item()), start.elapsed_time(end)


def add_latency(dev) -> dict:
    """The dependent-add latency of float32 and float64 on the card: one
    thread adds a value to itself 2^24 times, each add waiting on the last
    (add_chain). Cycles per add from the SM's clock counter, ns per add
    from CUDA events around the launch, beside the SM clock nvidia-smi
    reports just after. A long segment's sum can go no faster than its
    rows times the ns per add."""
    chain = ctypes.CDLL(str(probe_path("add_chain")))
    n = 1 << 24
    out = {}
    card = card_name()
    for dtype in (torch.float32, torch.float64):
        add_chain(chain, dtype, 64, dev)          # warm the launch path
        cycles, ms = add_chain(chain, dtype, n, dev)
        clocks = subprocess.run(
            ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60).stdout.split(",")
        sm, sm_max = (float(c) for c in clocks[:2])
        out[dtype] = ns = ms * 1e6 / n
        print(f"add latency {str(dtype)[6:]} ({card}): {cycles / n:.3f} "
              f"cycles per "
              f"dependent add (SM clock counter), {ns:.4f} ns per add (CUDA "
              f"events: {cycles / n / ns:.3f} GHz); nvidia-smi SM clock "
              f"{sm:g} MHz (max {sm_max:g}): {cycles / n / sm * 1e3:.4f} ns "
              f"per add at it")
    return out


def segment_graph_check(plan, plan_cpu, n_rows: int, w: int, dtype, dev,
                        r, what: str) -> None:
    """segment_sum captured in a CUDA graph and replayed with new rows: bit
    for bit the eager call's and CPU index_add_'s."""
    x = torch.zeros((n_rows, w), dtype=dtype, device=dev)
    segment_sum(x, plan)                          # warm outside the capture
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = segment_sum(x, plan)
    for _ in range(2):
        new = torch.from_numpy(r.standard_normal((n_rows, w))
                               * 10.0 ** r.uniform(-3, 3, (n_rows, w))
                               ).to(dtype)
        x.copy_(new.to(dev))
        graph.replay()
        torch.cuda.synchronize()
        check(torch.equal(out, segment_sum(x, plan)),
              f"segment_sum replayed from a CUDA graph equals eager ({what})")
        check(torch.equal(out.cpu(), segment_sum(new, plan_cpu)),
              f"segment_sum replayed from a CUDA graph equals CPU "
              f"index_add_ ({what})")


def deterministic_index_add(buf, plan, x):
    """One index_add_ call under torch.use_deterministic_algorithms(True),
    restored after: PyTorch's fixed-order sum (a sort, then each index's
    rows added in order)."""
    prev = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        return buf.index_add_(0, plan.idx, x)
    finally:
        torch.use_deterministic_algorithms(prev)


def kernel_segment(dev) -> dict:
    """segment_sum against CPU index_add_ (its plain version), bit for bit
    and equal on a second call, in float32 and float64 at every shape set,
    and replayed from a CUDA graph at the window BA's and pose graph's
    shapes; each float32 sum timed per call and alone beside its bound
    (the larger of its bytes and its longest segment's chain of dependent
    adds), the plain version on the card (zeros + index_add_), the
    deterministic index_add_ (per call and alone, its bits against the
    kernel's) and, as an aside, the atomic index_add_ per call."""
    ns_add = add_latency(dev)
    r = np.random.default_rng(7)
    rows, out = [], None
    for name in SEGMENT_SETS:
        for what, idx, n, widths in segment_sets(name):
            plan = segment_plan(torch.from_numpy(idx).to(dev), n)
            plan_cpu = segment_plan(torch.from_numpy(idx), n)
            longest = int(plan_cpu.lengths.max())
            for w in widths:
                for dtype in (torch.float32, torch.float64):
                    x = torch.from_numpy(
                        r.standard_normal((len(idx), w))
                        * 10.0 ** r.uniform(-3, 3, (len(idx), w))).to(dtype)
                    want = segment_sum(x, plan_cpu)
                    xd = x.to(dev)
                    got = segment_sum(xd, plan)
                    again = segment_sum(xd, plan)
                    check(torch.equal(got.cpu(), want),
                          f"segment_sum equals CPU index_add_ bit for bit "
                          f"({name} {what} width {w} {dtype})")
                    check(torch.equal(got, again), f"segment_sum repeats "
                          f"bit for bit ({name} {what} width {w} {dtype})")
                    if (name, what) in SEGMENT_GRAPHED:
                        segment_graph_check(plan, plan_cpu, len(idx), w,
                                            dtype, dev, r,
                                            f"{name} {what} width {w} "
                                            f"{dtype}")
                xd = xd.float()
                got = segment_sum(xd, plan)
                ms = time_ms(lambda: segment_sum(xd, plan), 20)
                plain_ms = time_ms(lambda: segment_sum_ref(xd, plan), 20)
                buf = torch.zeros((n, w), device=dev)
                atomic_ms = time_ms(lambda: buf.index_add_(0, plan.idx, xd),
                                    20)
                det = deterministic_index_add(torch.zeros_like(buf), plan, xd)
                det_equal = torch.equal(det, got)
                det_ms = time_ms(
                    lambda: deterministic_index_add(buf, plan, xd), 20)
                det_alone, _, det_launches = device_ms(
                    lambda: deterministic_index_add(buf, plan, xd), 20, None)
                # the main paths' sums: PyTorch's deterministic index_add_
                # adds in the same order (elsewhere it may not: printed)
                if name in ("global_ba", "window_grid", "pose_graph"):
                    check(det_equal, f"deterministic index_add_ equals "
                          f"segment_sum bit for bit ({name} {what} width "
                          f"{w})")
                kms = kernel_alone("segment_sum",
                                   lambda: segment_sum(xd, plan), ms,
                                   f" ({name} {what}, [{len(idx)}, {w}] -> "
                                   f"[{n}, {w}])")
                io = nbytes(xd, plan.perm, plan.offsets) + 4 * n * w
                bytes_ms, _ = least_ms(io, 0.0)
                chain_ms = longest * ns_add[torch.float32] * 1e-6
                bms = max(bytes_ms, chain_ms)
                by = "bytes" if bytes_ms >= chain_ms else "chain"
                rows.append(dict(
                    set=name, sum=what, rows=len(idx), n=n, width=w,
                    longest=longest, long=int(plan.long_count),
                    ms=ms, kernel_ms=kms, plain_ms=plain_ms,
                    library_ms=det_ms, library_alone_ms=det_alone,
                    library_launches=det_launches, library_equal=det_equal,
                    atomic_ms=atomic_ms,
                    bytes_ms=bytes_ms, chain_ms=chain_ms, bound_ms=bms,
                    bound_by=by))
                if (name, what, w) == SEGMENT_ROW:
                    # the chain is the adds' own floor: their operations
                    # at the rate a dependent add allows
                    out = dict(err=0.0, ms=ms, kernel_ms=kms,
                               plain_ms=plain_ms, bound_ms=bms,
                               bound_by="bytes" if by == "bytes"
                               else "operations", library_ms=det_ms)
    print(f"kernel segment_sum ({card_name()}): equal to CPU index_add_ "
          f"bit for bit and "
          f"run to run in float32 and float64 at {SEGMENT_SETS}, replayed "
          f"from a CUDA graph at {SEGMENT_GRAPHED}, and to the "
          f"deterministic index_add_; float32 times (ms; library = "
          f"deterministic index_add_ per call, atomic = index_add_ per call, "
          f"an aside): {json.dumps(rows)}")
    return out


SEGMENT_FILES = ("ops/cuda/build.py", "ops/cuda/segment.py",
                 "csrc/segment.cu")


def checkout_modules(root: str, names) -> list:
    """The modules ops/cuda/<name>.py of the checkout at `root` (with their
    own build into root's _build), imported beside this process's package:
    the package __init__ files are left out, and sys.modules is restored
    after."""
    prefix = "visualslam_tpu_torch"
    own = {k: m for k, m in sys.modules.items()
           if k == prefix or k.startswith(prefix + ".")}
    pkg = os.path.join(os.path.abspath(root), prefix)
    try:
        for k in own:
            del sys.modules[k]
        for sub in ("", ".ops", ".ops.cuda", ".utils"):
            stub = types.ModuleType(prefix + sub)
            stub.__path__ = [os.path.join(pkg, *sub.split(".")[1:])]
            sys.modules[prefix + sub] = stub
        return [importlib.import_module(f"{prefix}.ops.cuda.{name}")
                for name in names]
    finally:
        for k in [k for k in sys.modules
                  if k == prefix or k.startswith(prefix + ".")]:
            del sys.modules[k]
        sys.modules.update(own)


def patched_copy(root, files, patches: dict) -> None:
    """Copies of the package's `files` (paths under visualslam_tpu_torch/)
    under `root`, each (old, new) text of `patches[file]` replaced once."""
    for rel in files:
        text = (build.PACKAGE / rel).read_text()
        for old, new in patches.get(rel, ()):
            check(text.count(old) == 1, f"{rel} holds {old.strip()} once")
            text = text.replace(old, new)
        dst = root / "visualslam_tpu_torch" / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(text)


def threshold_variant(long_rows: int) -> object:
    """This checkout's segment sum with the long-segment threshold set to
    `long_rows` (LONG_ROWS in segment.py, kLongRows in segment.cu), from a
    patched copy of its three files under the build directory."""
    root = build.BUILD_DIR / f"long{long_rows}"
    patched_copy(root, SEGMENT_FILES, {
        "ops/cuda/segment.py": [(f"LONG_ROWS = {LONG_ROWS}\n",
                                 f"LONG_ROWS = {long_rows}\n")],
        "csrc/segment.cu": [(f"kLongRows = {LONG_ROWS};",
                             f"kLongRows = {long_rows};")]})
    return checkout_modules(str(root), ("segment",))[0]


def segment_turns(parent_root: str, dev) -> None:
    """The segment sum of another checkout (the parent commit's: `git
    archive <commit> | tar -x -C <dir>`), through its own plan and wrapper,
    against this one at every shape set: each float32 sum alone (profiler)
    in turns parent, change, change, parent; then this kernel's
    long-segment threshold swept over 16..256 rows on the power-law set
    (patched copies of this kernel and wrapper, alone times)."""
    from concurrent.futures import ThreadPoolExecutor

    parent, = checkout_modules(parent_root, ("segment",))
    variants = {t: threshold_variant(t) for t in (16, 32, 128, 256)}
    mods = [parent, *variants.values()]
    with ThreadPoolExecutor(max_workers=len(mods)) as pool:
        list(pool.map(lambda m: m.build.build("segment"), mods))
    name_of = DEVICE_NAMES["segment_sum"]
    rows = []
    for name in SEGMENT_SETS:
        for what, idx, n, widths in segment_sets(name):
            idx_dev = torch.from_numpy(idx).to(dev)
            plan = segment_plan(idx_dev, n)
            pplan = parent.segment_plan(idx_dev, n)
            for w in widths:
                xd = torch.randn((len(idx), w), device=dev)
                check(torch.equal(parent.segment_sum(xd, pplan),
                                  segment_sum(xd, plan)),
                      f"parent and change agree bit for bit ({name} {what} "
                      f"width {w})")
                turns = [device_ms(lambda: fn(xd, p), 20, name_of)[0]
                         for fn, p in ((parent.segment_sum, pplan),
                                       (segment_sum, plan),
                                       (segment_sum, plan),
                                       (parent.segment_sum, pplan))]
                rows.append(dict(set=name, sum=what, width=w,
                                 parent=[turns[0], turns[3]],
                                 change=[turns[1], turns[2]]))
    card = card_name()
    print(f"segment_sum turns ({card}; ms alone, float32; parent "
          f"{parent_root}): {json.dumps(rows)}")
    _, idx, n, widths = segment_sets("power_law")[0]
    idx_dev = torch.from_numpy(idx).to(dev)
    sums = {t: (m.segment_plan, m.segment_sum) for t, m in variants.items()}
    sums[LONG_ROWS] = (segment_plan, segment_sum)
    sweep = []
    for t, (plan_fn, sum_fn) in sorted(sums.items()):
        plan = plan_fn(idx_dev, n)
        check(int(plan.long_count) == int((plan.lengths >= t).sum()),
              f"threshold {t}: its plan's long list")
        for w in widths:
            xd = torch.randn((len(idx), w), device=dev)
            check(torch.equal(sum_fn(xd, plan),
                              segment_sum(xd, segment_plan(idx_dev, n))),
                  f"threshold {t} agrees bit for bit (width {w})")
            sweep.append(dict(long_rows=t, width=w, ms=device_ms(
                lambda: sum_fn(xd, plan), 20, name_of)[0]))
    print(f"segment_sum long_rows sweep ({card}; power_law, ms alone, "
          f"float32): {json.dumps(sweep)}")


def init_turn(fa: Features, fb: Features, intr, parent_sl) -> dict:
    """The sequence's two-view init program (the tracker's "ransac" on
    FAST_CONFIG, frames 0 -> 8's matches) with the parent's sym_eigh and
    svd3 (parent_sl: its small_linalg module) and with this checkout's,
    two programs captured side by side: equal bit for bit, then in turns
    parent, change, change, parent each replay's host-clock ms (wall_ms,
    synchronized) and its device ms (profiler, every kernel)."""
    m = match_features(fa, fb, FAST_CONFIG.match)
    x = (normalized(fa.keypoints.yx[m.idx_a.long()].flip(-1), intr),
         normalized(fb.keypoints.yx[m.idx_b.long()].flip(-1), intr),
         m.valid)
    theirs = KERNELS._replace(sym_eigh=parent_sl.sym_eigh,
                              svd3=parent_sl.svd3)
    progs = {k: GraphProgram(slam_tracker._ransac_body) for k in "pc"}
    runs = {"p": lambda: progs["p"](x, (FAST_CONFIG.ransac, theirs), 7),
            "c": lambda: progs["c"](x, (FAST_CONFIG.ransac, KERNELS), 7)}
    got = {k: fn() for k, fn in runs.items()}
    check(all(torch.equal(a, b) for a, b in zip(got["p"], got["c"])),
          "the init program with the parent's and this checkout's solvers "
          "agrees bit for bit")
    order = ("p", "c", "c", "p")
    host = [wall_ms(runs[k], 20) for k in order]
    device = [device_ms(runs[k], 20, None)[0] for k in order]
    return dict(kernel="two-view init program (8-point, 512)",
                parent_ms=[host[0], host[3]], change_ms=[host[1], host[2]],
                parent_device_ms=[device[0], device[3]],
                change_device_ms=[device[1], device[2]],
                inliers=int(got["c"][4]))


def solver_turns(parent_root: str, dev, frames_dev: torch.Tensor,
                 frontend: SiftFrontend, seq) -> None:
    """sym_eigh, svd3 and triangulate_dlt of another checkout (the parent
    commit's: `git archive <commit> | tar -x -C <dir>`), through its own
    wrappers and build, against this one's on the init's and the engine's
    own inputs (frames 0 -> 8: the 8-point's 512 normal matrices and its
    refit, the five-point's 128 9x9 and 1280 10x10 systems; the 8-point's
    512 Fs, the refit Fs and essential matrices of both solvers, the
    8-point's essential matrix alone; keyframe 8, frame 12 at
    DEFAULT_CONFIG's 512 and ENGINE_CONFIG's 1024 match slots): equal bit
    for bit, then each alone (profiler) and per call (CUDA events) in turns
    parent, change, change, parent, beside the chain floor (the longest
    matrix's rotations x the rotation latency of ROTATION_PROBES that
    kernel_small_linalg and kernel_triangulate take it at; triangulate_dlt
    also beside its own rotation's chain) and torch.linalg.eigh's / svd's
    device kernels on the same matrices."""
    from concurrent.futures import ThreadPoolExecutor

    names = ("small_linalg", "triangulate")
    parent_sl, parent_tri = checkout_modules(parent_root, names)
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        list(pool.map(parent_sl.build.build, names))
    lat = rotation_latency(dev)
    fa, fb, intr, _ = two_view_pair(frames_dev, frontend, seq, dev)
    mats = init_matrices(fa, fb, intr, dev)
    e8, e5 = mats["8pt"]["sym_eigh"], mats["5pt"]["sym_eigh"]
    s8, s5 = mats["8pt"]["svd3"], mats["5pt"]["svd3"]
    feats = frontend(frames_dev[8:8 + BATCH])
    cases = [("sym_eigh", (x,), ksl.sym_eigh, parent_sl.sym_eigh)
             for x in (e8[0], e8[1], e5[0], e5[1].reshape(-1, 10, 10))]
    cases += [("svd3", (x,), ksl.svd3, parent_sl.svd3)
              for x in (s8[0], torch.stack([x.reshape(3, 3)
                                            for x in s8[-2:] + s5[-2:]]),
                        s8[-1].reshape(1, 3, 3))]
    cases += [("triangulate_dlt",
               triangulation_inputs(feats, seq, 0, 4, cfg, dev)[:4],
               ktri.triangulate_dlt, parent_tri.triangulate_dlt)
              for cfg in (DEFAULT_CONFIG, ENGINE_CONFIG)]
    rows = []
    for name, args, mine, theirs in cases:
        got, ref = mine(*args), theirs(*args)
        got, ref = ((got,), (ref,)) if name == "triangulate_dlt" else (
            got, ref)
        shape = tuple(args[-1].shape)
        check(all(torch.equal(a, b) for a, b in zip(got, ref)),
              f"{name} {shape}: parent and change agree bit for bit")
        order = (theirs, mine, mine, theirs)
        for _ in range(50):         # the card's clocks up before the turns
            for f in order:
                f(*args)
        torch.cuda.synchronize()
        alone = [device_ms(lambda f=f: f(*args), 20, DEVICE_NAMES[name])[0]
                 for f in order]
        call = [time_ms(lambda f=f: f(*args), 20) for f in order]
        x = args[0]
        own = {}
        if name == "triangulate_dlt":
            longest, ns = TRI_ROTATIONS, lat["f32_one_test"]
            own = dict(own_chain_ms=longest * lat["f32_stand_ins"] * 1e-6)
            M = ktri.normal_matrices(*args)
            lib_fn = torch.linalg.eigh
        else:
            n = x.shape[-1]
            replay = (ksl.sym_eigh_jacobi if name == "sym_eigh"
                      else ksl.svd3_jacobi)
            with counted_rotations(x.numel() // (n * n)) as per_matrix:
                replay(x.cpu())
            longest = int(per_matrix.max())
            ns = lat["f64" if name == "sym_eigh" else "f32_one_test"]
            M = x
            lib_fn = (torch.linalg.eigh if name == "sym_eigh"
                      else torch.linalg.svd)
        lib = device_ms(lambda: lib_fn(M), 20, None)[0]
        rows.append(dict(
            kernel=name, shape=list(shape),
            parent_ms=[alone[0], alone[3]], change_ms=[alone[1], alone[2]],
            parent_call_ms=[call[0], call[3]],
            change_call_ms=[call[1], call[2]],
            rotations=longest, chain_ms=longest * ns * 1e-6, **own,
            library_ms=lib))
    rows.append(init_turn(fa, fb, intr, parent_sl))
    print(f"solver turns ({card_name()}; ms alone on the device and per "
          f"call, parent {parent_root}; chain floor = the longest matrix's "
          f"rotations x the fastest rotation latency that keeps the "
          f"kernel's bits (own_chain_ms: triangulate_dlt's own rotation); "
          f"library_ms = torch.linalg.eigh's (svd's for svd3) device "
          f"kernels on the same matrices): {json.dumps(rows)}")


def phase_kernels(batch: torch.Tensor, frontend: SiftFrontend, seq,
                  dev, frames_dev: torch.Tensor) -> dict:
    """Each kernel against its plain version at the main path's shapes
    (batch: frames 8..23 of `seq`; the two-view solvers' on frames 0 and
    8 of frames_dev)."""
    cfg = FAST_CONFIG
    thr = cfg.sift.contrast_threshold
    cap = cfg.sift.octave_capacity(0)
    ss = build_pyramid(batch.float() * (1.0 / 255.0), cfg.pyramid,
                       frontend.bands)
    out = kernel_extrema(ss, thr, cap)
    out.update(kernel_patches(ss, cfg, dev))
    del ss

    out["blur_stack"] = kernel_blur(batch, frontend, dev)
    feats = frontend(batch)
    out["l2_2nn"] = kernel_2nn(feats, dev)
    out["segment_sum"] = kernel_segment(dev)
    lat = rotation_latency(dev)
    out["triangulate_dlt"] = kernel_triangulate(feats, seq, dev, lat)
    out.update(kernel_small_linalg(frames_dev, frontend, seq, dev, lat))
    for name, r in out.items():
        lib = ("none" if r["library_ms"] is None
               else f"{r['library_ms']:.4f} ms")
        alone = ("not measured" if r["kernel_ms"] is None
                 else f"{r['kernel_ms']:.4f} ms")
        print(f"time {name}: kernel alone {alone}, call "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']}), library call {lib}")
    return out


STAGES = ("pyramid", "extrema", "orientation", "descriptor", "merge")


def frontend_stages(frontend: SiftFrontend, batch: torch.Tensor) -> tuple:
    """One frontend batch stage by stage, as detect_and_describe_sift runs
    it, with a CUDA event after each stage: ({stage: device ms between
    events, summed over the octaves}, features)."""
    cfg = FAST_CONFIG
    marks = []

    def mark(name):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    mark(None)
    ss = build_pyramid(batch.float() * (1.0 / 255.0), cfg.pyramid,
                       frontend.bands)
    mark("pyramid")
    per_oct = []
    for o in range(cfg.pyramid.num_octaves):
        lvl, y, x, offset, resp, valid = detect_extrema(
            ss.dog[o], cfg.sift, cfg.sift.octave_capacity(o), KERNELS)
        mark("extrema")
        src = patch_source(ss, o, lvl, y, x, cfg.sift)
        kps, cand_idx = _orientation_pass(src, lvl, y, x, offset, resp,
                                          valid, cfg.pyramid, cfg.sift)
        mark("orientation")
        desc = describe_octave(src, cand_idx, kps, cfg.sift)
        mark("descriptor")
        per_oct.append(octave_result(kps, desc, o, cfg.pyramid))
    feats = merge_octaves(per_oct, cfg.sift)
    mark("merge")
    torch.cuda.synchronize()
    ms = dict.fromkeys(STAGES, 0.0)
    for (_, a), (name, b) in zip(marks, marks[1:]):
        ms[name] += a.elapsed_time(b)
    return ms, feats


EXTREMA_PARTS = ("contiguous", "kernel", "top-k select", "cubes + localize")


def extrema_parts(frontend: SiftFrontend, batch: torch.Tensor) -> list:
    """The frontend's extrema stage of one batch, octave by octave and part
    by part as detect_extrema runs it under FAST_CONFIG (the fused
    winners), with a CUDA event after each part: [{part: device ms
    between events}] per octave. Each octave's result is checked against
    detect_extrema's."""
    cfg = FAST_CONFIG
    thr = cfg.sift.contrast_threshold
    ss = build_pyramid(batch.float() * (1.0 / 255.0), cfg.pyramid,
                       frontend.bands)
    per_oct = []
    for o, dog in enumerate(ss.dog):
        cap = cfg.sift.octave_capacity(o)
        marks = [torch.cuda.Event(enable_timing=True)]
        marks[0].record()

        def mark():
            marks.append(torch.cuda.Event(enable_timing=True))
            marks[-1].record()

        dog = dog.contiguous()
        mark()
        smax, srow = KERNELS.extrema_winners(dog, thr)
        mark()
        B, D, _, _ = dog.shape
        Wp = smax.shape[-1]
        flat = smax.reshape(B, -1)
        idx, sel = block_top_k_select(flat, flat > NONE / 10, cap)
        rem = idx % ((D - 2) * Wp)
        lvl = (rem // Wp + 1).to(torch.int32)
        y = ((idx // ((D - 2) * Wp)) * TILE_H
             + srow.reshape(B, -1).gather(1, idx)).to(torch.int32)
        x = (rem % Wp).to(torch.int32)
        mark()
        one = torch.ones_like(lvl)
        lvl, y, x = (torch.where(sel, v, one) for v in (lvl, y, x))
        loc = localize(gather_cubes(dog, lvl, y, x), cfg.sift)
        valid = (sel & loc.converged & loc.edge_ok
                 & (loc.contrast.abs() > cfg.sift.contrast_threshold))
        mark()
        torch.cuda.synchronize()
        want = detect_extrema(ss.dog[o], cfg.sift, cap, KERNELS)
        check(all(torch.equal(a, b) for a, b in zip((lvl, y, x, valid),
                                                    want[:3] + want[5:])),
              f"the staged extrema of octave {o} equal detect_extrema's")
        per_oct.append({n: a.elapsed_time(b) for n, a, b in
                        zip(EXTREMA_PARTS, marks, marks[1:])})
    return per_oct


def compare_paths(fk: Features, fp: Features) -> None:
    """Kernel path against plain path, frame by frame: valid counts within
    2%, >= 95% of keypoints within 0.5 px of a counterpart, median
    descriptor cosine of coincident keypoints > 0.999."""
    for b in range(fk.descriptors.shape[0]):
        vk = fk.keypoints.valid[b]
        vp = fp.keypoints.valid[b]
        nk, npl = int(vk.sum()), int(vp.sum())
        check(abs(nk - npl) <= 0.02 * npl,
              f"frame {b}: valid counts {nk} vs plain {npl} within 2%")
        d = torch.cdist(fp.keypoints.yx[b][vp], fk.keypoints.yx[b][vk],
                        compute_mode="donot_use_mm_for_euclid_dist")
        dmin, j = d.min(dim=1)
        near = (dmin < 0.5).float().mean().item()
        check(near >= 0.95, f"frame {b}: {near:.3f} of keypoints within "
              "0.5 px of a counterpart")
        close = dmin < 1e-3
        a = fp.descriptors[b][vp][close]
        k = fk.descriptors[b][vk][j[close]]
        cos = (a * k).sum(1) / (a.norm(dim=1) * k.norm(dim=1)).clamp_min(1e-9)
        check(cos.median().item() > 0.999,
              f"frame {b}: median descriptor cosine > 0.999")


def phase_slice(frames_dev: torch.Tensor, frontend: SiftFrontend,
                plain: SiftFrontend) -> dict:
    cfg = FAST_CONFIG
    batch = frames_dev[8:8 + BATCH]
    # the main path, through the entry points a user calls
    reset_launch_counts()
    feats = frontend(batch)
    matches = match_features(*frame_pairs(feats), cfg.match)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"slice launches: {launches}")
    for name in FRONTEND_KERNELS:
        check(launches[name] == cfg.pyramid.num_octaves,
              f"{name} launched once per octave on the frontend path")
    for name in ("blur_stack", "l2_2nn", "extrema_score"):
        check(launches[name] == 0, f"{name} not launched under FAST_CONFIG "
              "(matmul blur, dense matcher, fused extrema)")

    K = cfg.sift.max_keypoints
    check(tuple(feats.descriptors.shape) == (BATCH, K, 128)
          and tuple(feats.keypoints.yx.shape) == (BATCH, K, 2),
          "feature shapes")
    check(bool(torch.isfinite(feats.descriptors).all()
               & torch.isfinite(feats.keypoints.yx).all()),
          "features are finite")
    counts = feats.keypoints.count().tolist()
    mcounts = matches.count().tolist()
    print(f"slice keypoints per frame: {counts}")
    print(f"slice matches per pair: {mcounts} (median "
          f"{float(np.median(mcounts))})")
    check(min(counts) >= MIN_KEYPOINTS, f">= {MIN_KEYPOINTS} keypoints")
    check(min(mcounts) >= MIN_MATCHES, f">= {MIN_MATCHES} matches per pair")

    compare_paths(feats, plain(batch))
    print("slice: kernel path agrees with the plain path on every frame")

    # frontend frames/s, both paths in turns, one distinct batch per turn
    fps = {"kernel": [], "plain": []}
    for k in range(8):
        imgs = frames_dev[k:k + BATCH]
        for name, fe in (("kernel", frontend), ("plain", plain)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fe(imgs)
            torch.cuda.synchronize()
            fps[name].append(BATCH / (time.perf_counter() - t0))
    med = {k: float(np.median(v)) for k, v in fps.items()}
    print(f"frontend frames/s (median of 8 batches of {BATCH}): kernel path "
          f"{med['kernel']:.1f}, plain path {med['plain']:.1f}")

    # where the frontend's time goes, kernel path, stage by stage
    ms, staged = frontend_stages(frontend, batch)
    check(torch.equal(staged.descriptors, feats.descriptors)
          and torch.equal(staged.keypoints.yx, feats.keypoints.yx),
          "the staged frontend equals SiftFrontend")
    runs = [frontend_stages(frontend, frames_dev[k:k + BATCH])[0]
            for k in range(5)]
    med = {n: float(np.median([r[n] for r in runs])) for n in STAGES}
    total = sum(med.values())
    print(f"frontend stages, kernel path (CUDA events between stages, "
          f"median of 5 batches of {BATCH}): " + ", ".join(
              f"{n} {med[n]:.3f} ms ({100 * med[n] / total:.1f}%)"
              for n in STAGES) + f"; {total:.3f} ms per batch, "
          f"{1e3 * BATCH / total:.1f} frames/s")
    # the extrema stage by octave and part
    runs = [extrema_parts(frontend, frames_dev[k:k + BATCH]) for k in range(5)]
    for o in range(len(runs[0])):
        med = {n: float(np.median([r[o][n] for r in runs]))
               for n in EXTREMA_PARTS}
        print(f"frontend extrema stage, octave {o} (CUDA events between "
              f"parts, median of 5 batches of {BATCH}): " + ", ".join(
                  f"{n} {v:.4f} ms" for n, v in med.items())
              + f"; {sum(med.values()):.4f} ms")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def rot_deg(Ra: np.ndarray, Rb: np.ndarray) -> np.ndarray:
    """Angle between rotations in degrees, from |Ra - Rb|_F =
    2 sqrt(2) sin(angle / 2) in float64 (arccos of the trace loses ~0.02
    degrees to float32 rounding near 0)."""
    d = np.linalg.norm((Ra.astype(np.float64) - Rb).reshape(len(Ra), 9),
                       axis=1)
    return np.degrees(2.0 * np.arcsin(np.clip(d / (2.0 * np.sqrt(2.0)),
                                              0.0, 1.0)))


def centres(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    return -np.einsum("fji,fj->fi", R, t)


def switched(counts: dict) -> dict:
    """The launch counts of the kernels that `KERNELS` / `PLAIN` switch
    (every kernel but segment_sum, which a CUDA tensor always takes)."""
    return {n: counts[n] for n in KERNELS._fields}


def count_syncs(fn) -> int:
    """Host syncs torch reports while fn() runs (sync debug mode)."""
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    # the mode also emits a one-off notice that it is a prototype
    return sum("called a synchronizing" in str(w.message) for w in caught)


def phase_track(frames_dev: torch.Tensor, seq: SyntheticSequence,
                fast_frontend: SiftFrontend, card: str, dev) -> dict:
    """The tracking slice under TRACK_CONFIG on frames 0..15, kernel path
    and plain path; returns the kernel path's launch counts."""
    cfg = TRACK_CONFIG
    print(f"track: {card}")
    batch = frames_dev[:BATCH]
    R_gt, t_gt = world_to_camera(seq.gt_poses[:BATCH])
    intr = torch.tensor(seq.intrinsics, device=dev)
    n_kf_steps = 3      # bootstrap depth probe, bootstrap, promotion
    runs = {}
    for name, kernels in (("kernel", KERNELS), ("plain", PLAIN)):
        fe = SiftFrontend(cfg, kernels).to(dev)
        # the main path, through the entry points a user calls; run_window's
        # ground-truth bootstrap stands in for the two-view init (A.7)
        reset_launch_counts()
        feats = fe(batch)
        run = run_window(port_ops(dev, kernels), feats, R_gt, t_gt, intr, cfg)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"track {name} path launches: {counts}")
        if kernels is KERNELS:
            want = dict.fromkeys(FRONTEND_KERNELS, cfg.pyramid.num_octaves)
            want.update(blur_stack=cfg.pyramid.num_octaves,
                        l2_2nn=2 * (BATCH + n_kf_steps), extrema_score=0,
                        triangulate_dlt=n_kf_steps, sym_eigh=0, svd3=0)
            check(switched(counts) == want, f"kernel path launches {want}")
        else:
            check(not any(switched(counts).values()),
                  "plain path launches none of the switched kernels")
        # the window BA's sums have no plain switch on the card
        check(counts["segment_sum"] > 0, f"{name}: the window BA's segment "
              "sums launch the kernel")
        tracked = np.arange(BATCH) >= 5
        rerr = rot_deg(run.R, R_gt)[tracked]
        perr = np.linalg.norm(centres(run.R, run.t) - centres(R_gt, t_gt),
                              axis=1)[tracked]
        inl = run.inliers[tracked]
        print(f"track {name}: ok {run.ok.astype(int).tolist()}, inliers "
              f"{inl.astype(int).tolist()}")
        print(f"track {name}: rotation error deg max {rerr.max():.4f} "
              f"(per frame {np.round(rerr, 4).tolist()}), position error "
              f"max {perr.max():.4f} (sequence units)")
        print(f"track {name}: new landmarks {run.new_landmarks}, max_depth "
              f"{run.max_depth:.2f}, BA cameras/landmarks/observations "
              f"{run.ba_sizes}, cost {run.ba_cost[0]:.6e} -> "
              f"{run.ba_cost[1]:.6e}")
        check(bool(run.ok[tracked].all()), f"{name}: every frame tracked")
        check(inl.min() >= MIN_INLIERS, f"{name}: >= {MIN_INLIERS} inliers")
        check(rerr.max() <= MAX_ROT_DEG, f"{name}: rotation <= {MAX_ROT_DEG}")
        check(perr.max() <= MAX_POS_ERR, f"{name}: position <= {MAX_POS_ERR}")
        init, final = run.ba_cost
        check(np.isfinite(final) and final <= init, f"{name}: BA cost falls")
        runs[name] = (fe, feats, run, counts)

    k, p = runs["kernel"][2], runs["plain"][2]
    base = np.linalg.norm(centres(R_gt, t_gt)[-1] - centres(R_gt, t_gt)[0])
    dr = rot_deg(k.R, p.R)[5:]
    dp = np.linalg.norm(centres(k.R, k.t) - centres(p.R, p.t), axis=1)[5:]
    di = np.abs(k.inliers - p.inliers)[5:] / np.maximum(p.inliers[5:], 1)
    print(f"track kernel vs plain: rotation max {dr.max():.5f} deg, "
          f"position max {dp.max():.3e} (baseline {base:.3f}), inliers max "
          f"{di.max():.3f} relative")
    check(dr.max() <= PATH_ROT_DEG, "paths agree in rotation")
    check(dp.max() <= PATH_POS_FRAC * base, "paths agree in position")
    check(di.max() <= PATH_INLIER_FRAC, "paths agree in inlier counts")

    # timings, kernel path
    fe, feats, run, counts = runs["kernel"]
    c = run.calls
    sub = frames_of(feats, slice(5, BATCH))               # the 11 frames

    def track():
        return track_batch(c["lmap"], sub, 0, c["state"], intr, cfg,
                           c["ok_min"])

    def promote():
        return keyframe_step(c["kf_ref"], c["feats"], c["lite"], intr, cfg,
                             run.max_depth)

    reset_launch_counts()
    track()
    check(launch_counts()["l2_2nn"] == 2 * (BATCH - 5),
          "l2_2nn launched twice per tracked frame")
    reset_launch_counts()
    promote()
    check(launch_counts()["l2_2nn"] == 2,
          "l2_2nn launched twice per keyframe_step")
    per_frame = wall_ms(track, 5) / (BATCH - 5)
    kf_ms = wall_ms(promote, 5)
    ba_ms = wall_ms(lambda: run_ba(c["problem"], cfg.ba), 5)
    syncs = count_syncs(track)
    kf_syncs = count_syncs(promote)
    print(f"track times ({card}): {per_frame:.3f} ms per tracked frame "
          f"(track_batch over {BATCH - 5} frames, median of 5), "
          f"keyframe_step {kf_ms:.3f} ms, run_ba {ba_ms:.3f} ms "
          f"({cfg.ba.iters} iterations, C={cfg.ba.max_cameras}, "
          f"L={cfg.ba.max_landmarks}, O={cfg.ba.max_observations})")
    print(f"track host syncs: {syncs} inside track_batch over "
          f"{BATCH - 5} frames, {kf_syncs} inside keyframe_step")
    check(kf_syncs == 0, "keyframe_step syncs the host nowhere (the "
          "triangulation kernel in the eigh's place)")

    fps = {"TRACK_CONFIG": [], "FAST_CONFIG": []}
    for i in range(8):
        imgs = frames_dev[i:i + BATCH]
        for name, f in (("TRACK_CONFIG", fe), ("FAST_CONFIG", fast_frontend)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f(imgs)
            torch.cuda.synchronize()
            fps[name].append(BATCH / (time.perf_counter() - t0))
    med = {n: float(np.median(v)) for n, v in fps.items()}
    print(f"frontend frames/s, kernel path (median of 8 batches of {BATCH}, "
          f"in turns): TRACK_CONFIG {med['TRACK_CONFIG']:.1f}, FAST_CONFIG "
          f"{med['FAST_CONFIG']:.1f}")
    return counts


# the host-side CUDA calls that put work on the card (a graph launch puts
# every kernel of its graph there at once)
HOST_LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC",
                     "cuLaunchKernel", "cuLaunchKernelEx", "cudaGraphLaunch",
                     "cudaMemcpyAsync", "cudaMemsetAsync")


def profile_call(fn) -> tuple:
    """(device kernel launches, device busy ms, profiled wall ms) of one
    fn() under torch.profiler; busy is the summed time of the device
    events, which run on one stream here. (None, None, wall) if the
    profiler saw no device event."""
    return profile_launches(fn)[:3]


def profile_launches(fn) -> tuple:
    """profile_call's (device kernel launches, busy ms, wall ms) and the
    host's launch calls (HOST_LAUNCH_CALLS: kernels, graphs, copies and
    fills) of one fn()."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.perf_counter() - t0)
    events = prof.events()
    host = sum(e.name in HOST_LAUNCH_CALLS for e in events
               if e.device_type == torch.autograd.DeviceType.CPU)
    dev_events = [e for e in events
                  if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        return None, None, wall, host
    kernels = [e for e in dev_events
               if not e.name.startswith(("Memcpy", "Memset"))]
    busy = sum(e.time_range.elapsed_us() for e in dev_events) / 1e3
    return len(kernels), busy, wall, host


ENGINE_PARTS = ("track_step_lite", "_window_ba", "refine_pose",
                "keyframe_step", "_verify_candidate")


def time_parts(module, names, fn, reps: int) -> dict:
    """{name: (median host-clock ms per call, calls per fn())} of the
    module-level functions `names` of `module` while fn() runs `reps`
    times, each call wrapped in synchronize (which serializes the launch
    queue, so the sum exceeds fn()'s own time)."""
    times = {n: [] for n in names}
    orig = {n: getattr(module, n) for n in names}

    def timed(name):
        def call(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = orig[name](*args, **kw)
            torch.cuda.synchronize()
            times[name].append(1e3 * (time.perf_counter() - t0))
            return out
        return call

    for n in names:
        setattr(module, n, timed(n))
    try:
        for _ in range(reps):
            fn()
    finally:
        for n, f in orig.items():
            setattr(module, n, f)
    return {n: (float(np.median(v)) if v else 0.0, len(v) / reps)
            for n, v in times.items()}


def engine_path(batch_fn, eager_fn, n_active: int, n_prom: int,
                what: str) -> dict:
    """One engine batch on the graph path (batch_fn) and the eager path
    (eager_fn), in turns: ms (median of 5), host syncs, the profiler's
    device kernels, host launch calls and busy share."""
    out = {}
    for name, fn in (("graph", batch_fn), ("eager", eager_fn)):
        out[name] = dict(ms=wall_ms(fn, 5))
    for name, fn in (("eager", eager_fn), ("graph", batch_fn)):
        out[name]["ms2"] = wall_ms(fn, 5)
        out[name]["syncs"] = count_syncs(fn)
        kernels, busy, wall, host = profile_launches(fn)
        out[name].update(kernels=kernels, busy=busy, wall=wall, host=host)
    for name, r in out.items():
        busy = ("not measured" if r["busy"] is None else
                f"{r['busy']:.3f} of {r['wall']:.3f} ms profiled "
                f"({100 * r['busy'] / r['wall']:.1f}%)")
        print(f"engine {what} {name} path: {r['ms']:.3f} / {r['ms2']:.3f} ms "
              f"per batch (median of 5, in turns graph, eager, eager, "
              f"graph), {r['syncs']} host syncs ({n_active} active frames, "
              f"{n_prom} promotions), {r['host']} host launch calls, "
              f"{r['kernels']} device kernels, device busy {busy}")
        check(r["syncs"] == n_active, f"engine {what} {name}: one host sync "
              "per active frame, none per promotion")
    return out


def phase_engine(frames_dev: torch.Tensor, seq: SyntheticSequence, card: str,
                 dev, save_features: str | None) -> dict:
    """The engine slice under ENGINE_CONFIG on frames 0..47, kernel path
    (engine_programs' captured graphs) and plain path (eager by
    construction); the graph program against the eager run_engine_batch
    bit for bit on the three batches; times of both. Returns the kernel
    path's launch counts."""
    cfg = ENGINE_CONFIG
    print(f"engine: {card}")
    nb = ENGINE_BATCHES
    n_frames = BATCH * nb
    R_gt, t_gt = world_to_camera(seq.gt_poses[:n_frames])
    intr = torch.tensor(seq.intrinsics, device=dev)
    active = np.arange(n_frames) >= ENGINE_START
    runs = {}

    def drive(fe, kernels):
        feats = [fe(frames_dev[BATCH * b:BATCH * (b + 1)]) for b in range(nb)]
        return feats, run_engine(port_ops(dev, kernels), feats, R_gt, t_gt,
                                 intr, cfg, ENGINE_START)

    for name, kernels in (("kernel", KERNELS), ("plain", PLAIN)):
        fe = SiftFrontend(cfg, kernels).to(dev)
        if kernels is KERNELS:
            # set-up: the program captures its graphs on its first batch
            # (the eager warm-up's launches stay out of the counted run)
            _, warm = drive(fe, kernels)
            torch.cuda.synchronize()
            prog = engine_programs(cfg, warm.ok_min, warm.max_depth)["batch"]
            for g in prog.captured.values():
                print(f"engine graphs ({card}): captured in "
                      f"{g.capture_s:.3f} s (warm-up included), static "
                      f"buffers and graph pools {g.pool_bytes / 2 ** 20:.1f} "
                      f"MiB; launches per replay: step "
                      f"{g.g_step.launches}, promote {g.g_promote.launches}")
        # the main path, through the entry points a user calls; the
        # ground-truth bootstrap stands in for the two-view init (A.7)
        reset_launch_counts()
        feats, run = drive(fe, kernels)
        torch.cuda.synchronize()
        counts = launch_counts()
        n_prom = [len(p) for p in run.proms]
        print(f"engine {name} path launches: {counts}")
        rerr = rot_deg(run.R, R_gt)[active]
        perr = np.linalg.norm(centres(run.R, run.t) - centres(R_gt, t_gt),
                              axis=1)[active]
        ate = ate_rmse(centres(run.R, run.t)[active],
                       centres(R_gt, t_gt)[active])
        inl = run.inliers[active]
        loops = [sum(int((r.loop[:, 1] > -2.0).sum()) for r in p)
                 for p in run.proms]
        print(f"engine {name}: promoted frames "
              f"{np.nonzero(run.promoted)[0].tolist()}, promotions per "
              f"batch {n_prom}, loop verifications with an eligible "
              f"candidate per batch {loops} (of {[3 * n for n in n_prom]}), "
              f"db_n after each batch {run.db_n}")
        print(f"engine {name}: inliers {inl.astype(int).tolist()} (ok_min "
              f"{run.ok_min}), max_depth {run.max_depth:.2f}")
        print(f"engine {name}: rotation error deg max {rerr.max():.4f}, "
              f"position error max {perr.max():.4f} (sequence units), ATE "
              f"{ate:.4f} over frames {ENGINE_START}..{n_frames - 1}")
        print(f"engine {name}: window-BA cost after each batch "
              f"{[t.ba_cost for t in run.tails]}")
        if kernels is KERNELS:
            per_batch = cfg.pyramid.num_octaves * nb
            want = dict.fromkeys(("extrema_score", "blur_stack",
                                  "orient_hist", "descriptor"), per_batch)
            # 2 per tracked frame, 2 per promotion (keyframe_step), 4 in the
            # bootstrap (depth probe + keyframe_step); loop verification runs
            # the dense matcher, as the reference's _sub_match_cfg; one
            # triangulation per keyframe_step
            want.update(extrema_winners=0,
                        l2_2nn=2 * int(active.sum()) + 2 * sum(n_prom) + 4,
                        triangulate_dlt=sum(n_prom) + 2, sym_eigh=0,
                        svd3=0)
            check(switched(counts) == want, f"kernel path launches {want}")
            if save_features:
                np.savez(save_features, intrinsics=seq.intrinsics,
                         R_gt=R_gt, t_gt=t_gt, **{
                             f"b{b}_{k}": v.cpu().numpy()
                             for b, f in enumerate(feats)
                             for k, v in zip(Keypoints._fields + (
                                 "descriptors",), tuple(f.keypoints) + (
                                 f.descriptors,))})
                print(f"engine: features saved to {save_features}")
        else:
            check(not any(switched(counts).values()),
                  "plain path launches none of the switched kernels")
        check(counts["segment_sum"] > 0, f"{name}: the window BA's segment "
              "sums launch the kernel")
        check(bool((inl >= run.ok_min).all()),
              f"{name}: every active frame tracked")
        check(inl.min() >= ENGINE_MIN_INLIERS,
              f"{name}: >= {ENGINE_MIN_INLIERS} inliers")
        check(min(n_prom) >= 1, f"{name}: a promotion in every batch")
        check(run.db_n == np.cumsum(n_prom).tolist(),
              f"{name}: db_n counts the promotions")
        for b, (recs, tail) in enumerate(zip(run.proms, run.tails)):
            flagged = np.nonzero(run.promoted[BATCH * b:BATCH * (b + 1)])[0]
            check([r.frame for r in recs] == flagged.tolist(),
                  f"{name}: batch {b}'s records are its promoted frames")
            if recs:
                check(np.isfinite(tail.ba_cost) and tail.ba_cost >= 0,
                      f"{name}: batch {b}'s window-BA cost")
        check(rerr.max() <= ENGINE_ROT_DEG,
              f"{name}: rotation <= {ENGINE_ROT_DEG}")
        check(perr.max() <= ENGINE_POS_ERR,
              f"{name}: position <= {ENGINE_POS_ERR}")
        check(ate <= ENGINE_ATE, f"{name}: ATE <= {ENGINE_ATE}")
        runs[name] = (fe, feats, run, counts)

    k, p = runs["kernel"][2], runs["plain"][2]
    base = np.linalg.norm(centres(R_gt, t_gt)[-1] - centres(R_gt, t_gt)[0])
    dr = rot_deg(k.R, p.R)[active]
    dp = np.linalg.norm(centres(k.R, k.t) - centres(p.R, p.t), axis=1)[active]
    print(f"engine kernel vs plain: rotation max {dr.max():.5f} deg, "
          f"position max {dp.max():.3e} (baseline {base:.3f}), promoted "
          f"frames equal {bool((k.promoted == p.promoted).all())}, db_n "
          f"{k.db_n} vs {p.db_n}")
    check(bool((k.promoted == p.promoted).all()), "paths promote alike")
    check(k.db_n == p.db_n, "paths' loop databases agree in size")
    check(dr.max() <= ENGINE_PATH_ROT_DEG, "paths agree in rotation")
    check(dp.max() <= ENGINE_PATH_POS_FRAC * base, "paths agree in position")

    # the graph program against the eager run_engine_batch on the kernel
    # path's three batches, from the same inputs
    fe, feats, run, counts = runs["kernel"]
    prog = engine_programs(cfg, run.ok_min, run.max_depth)["batch"]
    for b, (persist, dyn) in enumerate(run.calls):
        pg, sg = prog(persist, dyn, feats[b], intr)
        pe, se = run_engine_batch(persist, dyn, feats[b], intr, cfg,
                                  run.ok_min, run.max_depth)
        differ = [f for f, x, y in zip(engine.EnginePersist._fields, sg, se)
                  if not torch.equal(x, y)]
        print(f"engine batch {b}: graph path against eager run_engine_batch "
              f"(ENGINE_CONFIG): packed equal bit for bit "
              f"{torch.equal(pg, pe)}, persist fields that differ {differ}")
        check(torch.equal(pg, pe) and not differ, f"engine batch {b}: the "
              "graph program equals the eager batch bit for bit")

    # timings: batch 1 re-run from the persist after batch 0, graph path
    # and eager path
    persist, dyn = run.calls[1]
    n1 = len(run.proms[1])

    def batch1(c=cfg):
        return engine_programs(c, run.ok_min, run.max_depth)["batch"](
            persist, dyn, feats[1], intr)

    def eager1(c=cfg):
        return run_engine_batch(persist, dyn, feats[1], intr, c, run.ok_min,
                                run.max_depth)

    # the same batch with promotions switched off: tracking alone
    no_kf = cfg.replace(keyframe_min_inliers=0, keyframe_max_gap=10 ** 6)
    paths = engine_path(batch1, eager1, BATCH, n1, "batch 1")
    track = engine_path(lambda: batch1(no_kf), lambda: eager1(no_kf), BATCH,
                        0, "batch 1 with promotions off")
    for name in ("graph", "eager"):
        b_ms = min(paths[name]["ms"], paths[name]["ms2"])
        t_ms = min(track[name]["ms"], track[name]["ms2"]) / BATCH
        print(f"engine times, {name} path ({card}): batch {b_ms:.3f} ms "
              f"(batch 1 from the persist after batch 0, {n1} promotions, "
              f"the faster of the two medians), {t_ms:.3f} ms per tracked "
              f"frame (the same batch with promotions off), "
              f"{(b_ms - BATCH * t_ms) / max(n1, 1):.3f} ms per promotion "
              f"(the difference)")
    parts = time_parts(engine, ENGINE_PARTS, eager1, 3)
    print("engine time by part of batch 1, eager path (host clock, "
          "synchronize around each call, median ms x calls per batch; "
          "refine_pose counts the re-refine and verification's four solves, "
          "which _verify_candidate includes): " + ", ".join(
              f"{n} {ms:.3f} x {k:g}" for n, (ms, k) in parts.items()))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    drive(fe, KERNELS)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    print(f"engine frames/s, frontend + bootstrap + engine over {n_frames} "
          f"frames (kernel path, graphs): {n_frames / dt:.1f} "
          f"({1e3 * dt:.1f} ms)")

    # the score map + full-map top-k against the fused winners
    fps = {"ENGINE_CONFIG": [], "TRACK_CONFIG": []}
    track_fe = SiftFrontend(TRACK_CONFIG).to(dev)
    track_fe(frames_dev[:BATCH])
    for i in range(8):
        imgs = frames_dev[i:i + BATCH]
        for name, f in (("ENGINE_CONFIG", fe), ("TRACK_CONFIG", track_fe)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            f(imgs)
            torch.cuda.synchronize()
            fps[name].append(BATCH / (time.perf_counter() - t0))
    med = {n: float(np.median(v)) for n, v in fps.items()}
    print(f"frontend frames/s, kernel path (median of 8 batches of {BATCH}, "
          f"in turns): ENGINE_CONFIG {med['ENGINE_CONFIG']:.1f}, "
          f"TRACK_CONFIG {med['TRACK_CONFIG']:.1f}")
    return counts


SEQ_BOUND_FRAMES = 56       # frames 0..55: the saved features' prefix
# the sequence's bounds on frames 0..55: half and twice the JAX package's
# Tracker on the same features (tests/jax_sequence_bounds.py on the
# features of a chip run, PERF.md: tracking ok 1.0, ATE 0.2081 after a
# Sim(3) alignment, 8 keyframes, mean inliers 81.04)
SEQ_BOUNDS = dict(ok=0.5, ate=0.4163, keyframes=(4, 16),
                  mean_inliers=(40.52, 162.07))
SEQ_PATH_KEYFRAMES = 0      # kernel vs plain path: keyframe counts apart
SEQ_PATH_ATE = 2.0          # kernel vs plain path: ATE within this factor
FRONTEND_PATH = ("extrema_winners", "orient_hist", "descriptor")


def sequence_stats(tracker, gt_centres: np.ndarray, n: int) -> dict:
    """Tracking-ok share, ATE (Sim(3)-aligned), keyframes and inliers of
    the tracker's frames 0..n-1."""
    frames = tracker.frames[:n]
    est = tracker.trajectory()[:n, :, 3]
    inl = [f.num_inliers for f in frames if f.num_inliers > 0]
    return dict(ok=float(np.mean([f.tracking_ok for f in frames])),
                ate=ate_rmse(est, gt_centres[:n]),
                keyframes=int(sum(f.is_keyframe for f in frames)),
                mean_inliers=float(np.mean(inl or [0])),
                min_inliers=int(min(inl or [0])))


class EagerProgram:
    """A solver program's eager function in the program's place, called as
    the program is (prepare: nothing to capture)."""

    def __init__(self, prog):
        self.fn = prog.fn

    def __call__(self, x, cfg):
        return self.fn(x, cfg)

    def prepare(self, x, cfg) -> None:
        pass


class EagerTracker(Tracker):
    """The tracker with every engine batch through the eager
    run_engine_batch in place of engine_programs' captured graphs, the
    loop closer's pose graph through the eager optimize_sim3_graph /
    optimize_pose_graph in place of their programs, and the two-view
    init's RANSAC through the eager estimate_relative_pose in place of the
    "ransac" program: the graph path's comparison, here and nowhere in the
    package."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        if self.loop_closer is not None:
            self.loop_closer.program = EagerProgram(self.loop_closer.program)

    def _engine_batch(self, persist, dyn, feats_b):
        return engine.run_engine_batch(persist, dyn, feats_b, self.intr,
                                       self.cfg, self._track_ok_min,
                                       self._max_depth, self.kernels)

    def _ransac(self, x1, x2, valid):
        return trs.estimate_relative_pose(
            x1, x2, valid, self.cfg.ransac,
            generator(self._split_seed(), self.device), self.kernels)


class SyncRecorder:
    """Inside the block: every host sync torch reports (sync debug mode)
    and, per engine batch (engine.EngineProgram.__call__ and
    engine.run_engine_batch wrapped, the outer call counted once), its
    syncs, active frames, packed telemetry and whether the call captured
    the program's graphs. keep: the inputs and results of the first `keep`
    graph-path batches that did not capture, for an eager re-run."""

    def __init__(self, keep: int = 0):
        self.keep = keep

    def __enter__(self):
        self._warn = warnings.catch_warnings(record=True)
        self._caught = self._warn.__enter__()
        warnings.simplefilter("always")
        self.batches, self.kept = [], []
        self._run = engine.run_engine_batch
        self._call = engine.EngineProgram.__call__
        depth = [0]

        def wrap(fn, program: bool):
            def counted(*a, **kw):
                if depth[0]:
                    return fn(*a, **kw)
                depth[0] += 1
                try:
                    args = a[1:] if program else a
                    persist, dyn, feats_b = args[:3]
                    n_cap = len(a[0].captured) if program else 0
                    s0 = self.syncs()
                    packed, p = fn(*a, **kw)
                    captured = program and len(a[0].captured) > n_cap
                    self.batches.append((self.syncs() - s0,
                                         dyn.stop - dyn.start, packed,
                                         feats_b.keypoints.yx.shape[0],
                                         captured))
                    if program and not captured and len(self.kept) < self.keep:
                        self.kept.append((a, kw, packed, p))
                finally:
                    depth[0] -= 1
                return packed, p
            return counted

        engine.run_engine_batch = wrap(self._run, False)
        engine.EngineProgram.__call__ = wrap(self._call, True)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("warn")
        return self

    def syncs(self) -> int:
        return sum("called a synchronizing" in str(w.message)
                   for w in self._caught)

    def __exit__(self, *exc):
        torch.cuda.set_sync_debug_mode("default")
        engine.run_engine_batch = self._run
        engine.EngineProgram.__call__ = self._call
        self._warn.__exit__(*exc)

    def rules(self) -> list:
        """[(syncs, active frames, promotions)] per engine batch that did
        not capture graphs."""
        return [(s, active, int(packed[B * 24].item()))
                for s, active, packed, B, cap in self.batches if not cap]

    def captures(self) -> list:
        """The same of the batches whose call captured the graphs (its
        synchronizations around the capture included)."""
        return [(s, active, int(packed[B * 24].item()))
                for s, active, packed, B, cap in self.batches if cap]


def check_sync_rule(name: str, rec: SyncRecorder) -> None:
    """Every engine batch that did not capture syncs once per active frame
    (its need_kf read) and never per promotion."""
    rules = rec.rules()
    print(f"{name} engine batches (syncs, active frames, promotions): "
          f"{rules}; batches that captured the graphs: {rec.captures()}")
    for s_, active, _ in rules:
        check(s_ == active, f"{name}: every engine batch syncs once per "
              "active frame (need_kf) and never per promotion")


def eager_replays(name: str, rec: SyncRecorder) -> None:
    """The kept graph-path batches again through the eager
    run_engine_batch: packed buffers and persists equal bit for bit."""
    for k, (a, kw, packed, p) in enumerate(rec.kept):
        prog, (persist, dyn, feats_b, intr) = a[0], a[1:5]
        kernels = a[5] if len(a) > 5 else kw.get("kernels", KERNELS)
        pe, se = run_engine_batch(persist, dyn, feats_b, intr, prog.cfg,
                                  prog.ok_min, prog.max_depth, kernels)
        differ = [f for f, x, y in zip(engine.EnginePersist._fields, p, se)
                  if not torch.equal(x, y)]
        print(f"{name}: engine batch {k} (frames {dyn.frame_base + dyn.start}"
              f"..{dyn.frame_base + dyn.stop - 1}) graph path against the "
              f"eager run_engine_batch: packed equal bit for bit "
              f"{torch.equal(packed, pe)}, persist fields that differ "
              f"{differ}")
        check(torch.equal(packed, pe) and not differ, f"{name}: the graph "
              "program equals the eager batch bit for bit")
    check(len(rec.kept) == rec.keep, f"{name}: {rec.keep} graph-path "
          "batches compared")


def instrumented_run(frames, seq, dev, cfg=FAST_CONFIG, compare: int = 0):
    """One kernel-path run of the bench's sequence under `cfg` with the
    host syncs counted (SyncRecorder): per process_stream call, and inside
    every engine batch (the engine's rule: one need_kf read per active
    frame). Also keeps the features of the tracker's first detection
    calls and the first `compare` graph-path batches. Returns (tracker, syncs
    per process_stream call, the SyncRecorder, detected Features)."""
    detected = []
    tracker = Tracker(cfg, seq.intrinsics, device=dev)
    detect = tracker.detect_batch

    def keep(imgs):
        f = detect(imgs)
        detected.append(f)
        return f

    tracker.detect_batch = keep
    stream = []
    solve = tracker._two_view_solve
    with SyncRecorder(compare) as rec:
        rec.inits, rec.init_args = [], None

        def timed(prev, feats):
            # (host syncs, ms, whether the call captured the program)
            prog = tracker._progs["ransac"]
            n_cap = len(prog.captured)
            torch.cuda.synchronize()
            s0, t0 = rec.syncs(), time.perf_counter()
            out = solve(prev, feats)
            rec.inits.append((rec.syncs() - s0,
                              1e3 * (time.perf_counter() - t0),
                              len(prog.captured) > n_cap))
            rec.init_args = rec.init_args or (prev, feats)
            return out

        tracker._two_view_solve = timed
        tracker.process_batch(frames[:bench.INIT_FRAMES], 0)
        for k in range(bench.INIT_FRAMES, len(frames), BATCH):
            s0 = rec.syncs()
            tracker.process_stream(frames[k:k + BATCH], k)
            stream.append(rec.syncs() - s0)
        s0 = rec.syncs()
        tracker.finish()
        stream.append(rec.syncs() - s0)
    del tracker._two_view_solve
    return tracker, stream, rec, detected


def init_turns(tracker, prev, feats) -> None:
    """One two-view init's solve (match, RANSAC, pose, the packed
    readback) on the tracker's "ransac" program and on the eager
    estimate_relative_pose, with one seed: equal bit for bit, ms per call
    (host clock) and host syncs per call of each."""
    seed = 12345
    tracker._split_seed = lambda: seed
    try:
        out, ms, syncs = [], [], []
        for eager in (False, True):
            if eager:
                tracker._ransac = types.MethodType(EagerTracker._ransac,
                                                   tracker)
            out.append(tracker._two_view_solve(prev, feats))
            ms.append(wall_ms(lambda: tracker._two_view_solve(prev, feats),
                              10))
            syncs.append(count_syncs(
                lambda: tracker._two_view_solve(prev, feats)))
    finally:
        del tracker._split_seed
        tracker.__dict__.pop("_ransac", None)
    same = all(np.array_equal(a, b) for a, b in zip(*out))
    print(f"sequence two-view init (FAST_CONFIG, the first init's frames): "
          f"{ms[0]:.3f} ms per call replaying the ransac program, "
          f"{ms[1]:.3f} ms eager (host clock, match and readback included), "
          f"host syncs per call {syncs[0]} / {syncs[1]}, results equal bit "
          f"for bit {same} ({out[0].n} inliers of {out[0].n_match} "
          f"matches)")
    check(same and syncs[0] == 1, "the two-view init's program equals the "
          "eager init bit for bit and syncs the host once")


def save_sequence_features(path: str, detected: list, seq) -> None:
    """The features of the tracker's first four detection calls (frames
    0..55: 8 + 3 x 16), the intrinsics and the ground-truth poses, as
    tests/jax_sequence_bounds.py reads them."""
    first = detected[:4]
    np.savez(path, intrinsics=seq.intrinsics,
             gt_poses=seq.gt_poses[:SEQ_BOUND_FRAMES],
             sizes=np.array([f.descriptors.shape[0] for f in first]),
             **{f"b{b}_{k}": v.cpu().numpy()
                for b, f in enumerate(first)
                for k, v in zip(Keypoints._fields + ("descriptors",),
                                tuple(f.keypoints) + (f.descriptors,))})
    print(f"features of frames 0..{SEQ_BOUND_FRAMES - 1} saved to {path}")


def check_bounds(name: str, stats: dict, bounds: dict) -> None:
    """A run's figures on frames 0..55 against half / twice the JAX
    package's Tracker on the same features."""
    check(stats["ok"] >= bounds["ok"], f"{name}: tracking-ok share")
    check(stats["ate"] <= bounds["ate"], f"{name}: ATE <= {bounds['ate']}")
    check(bounds["keyframes"][0] <= stats["keyframes"]
          <= bounds["keyframes"][1],
          f"{name}: keyframes within {bounds['keyframes']}")
    check(bounds["mean_inliers"][0] <= stats["mean_inliers"]
          <= bounds["mean_inliers"][1],
          f"{name}: mean inliers within {bounds['mean_inliers']}")


def eager_sequence_run(frames, seq, dev, gt) -> dict:
    """bench.run_once with EagerTracker (every engine batch through the
    eager run_engine_batch), timed once: frames/s, the time by stage and
    frames 0..55 against SEQ_BOUNDS."""
    timer = StageTimer()
    bench.Tracker = EagerTracker
    try:
        tracker, seconds = bench.run_once(frames, seq.intrinsics,
                                          FAST_CONFIG, dev, KERNELS, timer)
    finally:
        bench.Tracker = Tracker
    pre = sequence_stats(tracker, gt, SEQ_BOUND_FRAMES)
    print(f"sequence frames/s, eager path (EagerTracker, one timed run, "
          f"after the first graph-path run): "
          f"{bench.SEQ_FRAMES / seconds:.2f}; time by stage: " + ", ".join(
              f"{k} {v['total_s']:.3f} s / {v['count']}"
              for k, v in timer.summary().items()))
    print(f"sequence eager path, frames 0..{SEQ_BOUND_FRAMES - 1}: "
          f"{json.dumps(pre)}")
    check_bounds("sequence eager path", pre, SEQ_BOUNDS)
    return dict(fps=bench.SEQ_FRAMES / seconds, stats=pre)


def phase_sequence(card: str, dev, save_features: str | None) -> dict:
    """The port's bench protocol on the kernel path (bench.run_once over
    96 + 8 frames, 3 timed runs), an instrumented kernel-path run (launch
    counts, host syncs, the engine's sync rule), and one untimed plain-path
    run; returns the instrumented run's launch counts."""
    t_phase = time.perf_counter()
    print(f"sequence: {card}")
    frames, seq = bench.render_sequence(bench.SEQ_FRAMES + bench.INIT_FRAMES)
    n = len(frames)
    gt = seq.gt_poses[:, :, 3]
    bench.warmup(FAST_CONFIG, dev, KERNELS)
    fps_runs, timers, trajs = [], [], []
    for k in range(3):
        timer = StageTimer()
        tracker, seconds = bench.run_once(frames, seq.intrinsics,
                                          FAST_CONFIG, dev, KERNELS, timer)
        fps_runs.append(bench.SEQ_FRAMES / seconds)
        timers.append((seconds, timer))
        trajs.append(tracker.trajectory())
        if k == 0:
            eager = eager_sequence_run(frames, seq, dev, gt)
    fps = float(np.median(fps_runs))
    frontend_fps = bench.bench_frontend(FAST_CONFIG, dev, KERNELS)
    diag = bench.diagnostics(tracker)
    print(f"sequence frames/s ({card}): {fps:.2f} (median of runs "
          f"{[round(v, 2) for v in fps_runs]}, {bench.SEQ_FRAMES} frames of "
          f"process_stream in batches of {BATCH} + finish; graph path), "
          f"eager path {eager['fps']:.2f}, frontend frames/s "
          f"{frontend_fps:.1f}; {json.dumps(diag)}")
    # printed, not checked: the tracker's lazy flush of an async window BA
    # (tracker.py _flush_pending_ba with wait=False) applies a result when
    # the card has finished it, which depends on timing
    same = [bool(np.array_equal(trajs[0], t)) for t in trajs[1:]]
    print(f"sequence: the three timed trackers' trajectories equal to the "
          f"first's bit for bit: {same} (max |difference| "
          f"{[float(np.abs(trajs[0] - t).max()) for t in trajs[1:]]})")
    seconds, timer = sorted(timers, key=lambda x: x[0])[1]
    summ = timer.summary()
    print(f"sequence time by stage (median run, {seconds:.3f} s; host "
          f"clock, StageTimer): " + ", ".join(
              f"{k} {v['total_s']:.3f} s / {v['count']}"
              for k, v in summ.items()))

    reset_launch_counts()
    tk, stream, rec, detected = instrumented_run(frames, seq, dev, compare=2)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"sequence launches (instrumented kernel-path run): {counts}")
    for name in FRONTEND_PATH:
        check(counts[name] > 0, f"{name} launched on the sequence path")
    for name in ("blur_stack", "l2_2nn", "extrema_score"):
        check(counts[name] == 0, f"{name} not launched under FAST_CONFIG")
    print(f"sequence host syncs per process_stream call: {stream[:-1]} "
          f"(finish: {stream[-1]})")
    warm = [(s_, round(ms, 3)) for s_, ms, cap in rec.inits if not cap]
    print(f"sequence two-view inits (host syncs, ms) per call: {warm}; "
          f"calls that captured the program: "
          f"{[(s_, round(ms, 3)) for s_, ms, cap in rec.inits if cap]}")
    check(bool(warm) and all(s_ == 1 for s_, _ in warm),
          "sequence: every two-view init syncs the host once")
    init_turns(tk, *rec.init_args)
    check_sync_rule("sequence", rec)
    eager_replays("sequence (FAST_CONFIG)", rec)
    del rec
    if save_features:
        save_sequence_features(save_features, detected, seq)

    plain, _ = bench.run_once(frames, seq.intrinsics, FAST_CONFIG, dev, PLAIN)
    out = {}
    for name, t in (("kernel", tk), ("plain", plain)):
        check(len(t.frames) == n and [f.frame_id for f in t.frames]
              == list(range(n)), f"{name}: every frame committed once")
        check(t._inflight is None, f"{name}: finish() leaves nothing in "
              "flight")
        full = sequence_stats(t, gt, n)
        pre = sequence_stats(t, gt, SEQ_BOUND_FRAMES)
        out[name] = (full, pre)
        print(f"sequence {name} path: {json.dumps(full)} over frames "
              f"0..{n - 1}; {json.dumps(pre)} over 0..{SEQ_BOUND_FRAMES - 1};"
              f" landmarks {int(t.map.lm_valid.sum())}, loop closures "
              f"{t.num_loop_closures}, relocalizations {t.relocalizations} "
              f"(database {t.db_relocalizations})")
        check_bounds(name, pre, SEQ_BOUNDS)
    k, p = out["kernel"][0], out["plain"][0]
    ratio = k["ate"] / max(p["ate"], 1e-9)
    print(f"sequence kernel vs plain: keyframes {k['keyframes']} vs "
          f"{p['keyframes']}, ATE {k['ate']:.4f} vs {p['ate']:.4f} (ratio "
          f"{ratio:.3f})")
    check(abs(k["keyframes"] - p["keyframes"]) <= SEQ_PATH_KEYFRAMES,
          "paths agree in keyframes")
    check(1 / SEQ_PATH_ATE <= ratio <= SEQ_PATH_ATE,
          f"paths' ATE within a factor {SEQ_PATH_ATE}")
    print(f"sequence phase wall time: {time.perf_counter() - t_phase:.1f} s")
    return counts


# the reference phase: DEFAULT_CONFIG (2x upsample, 4 octaves, float32
# patches of 28 rows) through the entry points cli detect / run --profile
# reference / accuracy's bench-96 reference row call
REF_CONFIG = DEFAULT_CONFIG
REF_MIN_KEYPOINTS = 800     # per frame (of 1024; 1024 measured, PR 9)
REF_MIN_MATCHES = 250       # per consecutive pair (of 512; 327-372)
# frames 0..55 of bench-96's reference row: half and twice the JAX
# package's Tracker on the same features (tests/jax_sequence_bounds.py
# --profile reference on the features of a chip run, PERF.md PR 9:
# tracking ok 1.0, ATE 0.8006 after a Sim(3) alignment, 17 keyframes,
# mean inliers 65.53)
REF_BOUNDS = dict(ok=0.5, ate=1.6013, keyframes=(8, 34),
                  mean_inliers=(32.76, 131.06))


def frontend_fps(fe, frames_dev: torch.Tensor, turns: int = 8) -> float:
    """Median frames/s of `fe` over `turns` distinct 16-frame batches."""
    fps = []
    for k in range(turns):
        imgs = frames_dev[k:k + BATCH]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fe(imgs)
        torch.cuda.synchronize()
        fps.append(BATCH / (time.perf_counter() - t0))
    return float(np.median(fps))


def feature_floors(name: str, feats: Features, cfg, min_kps: int,
                   min_matches: int, width: int, h: int, w: int) -> None:
    """Shapes, finite values, keypoints inside the h x w frame, and the
    keypoint and match floors of a 16-frame batch."""
    K = feats.keypoints.yx.shape[1]
    check(tuple(feats.descriptors.shape) == (BATCH, K, width),
          f"{name}: descriptor shape")
    v = feats.keypoints.valid
    yx = feats.keypoints.yx[v]
    check(bool(torch.isfinite(yx).all()) and bool(
        torch.isfinite(feats.descriptors.float()).all()),
        f"{name}: features are finite")
    check(bool((yx >= 0).all() & (yx[:, 0] < h).all() & (yx[:, 1] < w).all()),
          f"{name}: keypoints in input-image pixels")
    counts = feats.keypoints.count().tolist()
    print(f"{name} keypoints per frame: {counts}")
    check(min(counts) >= min_kps, f"{name}: >= {min_kps} keypoints")
    if min_matches:
        m = match_features(*frame_pairs(feats), cfg.match).count().tolist()
        print(f"{name} matches per pair: {m}")
        check(min(m) >= min_matches, f"{name}: >= {min_matches} matches")


def sequence_run(name: str, cfg, frames, seq, dev, save: str | None,
                 bounds: dict) -> dict:
    """bench's protocol under `cfg` on `frames` (0..7 through
    process_batch, then batches of 16 through process_stream, finish),
    timed once after a warmup tracker; an instrumented run (launches, host
    syncs per call, the engine's sync rule in every batch, the features of
    frames 0..55); an untimed plain-path run of frames 0..55; both paths'
    frames 0..55 against `bounds`. Returns the instrumented run's launch
    counts."""
    bench.warmup(cfg, dev, KERNELS)
    timer = StageTimer()
    tracker, seconds = bench.run_once(frames, seq.intrinsics, cfg, dev,
                                      KERNELS, timer)
    n_timed = len(frames) - bench.INIT_FRAMES
    print(f"{name} sequence frames/s: {n_timed / seconds:.2f} ({n_timed} "
          f"frames of process_stream in batches of {BATCH} + finish, one "
          f"timed run, {seconds:.3f} s); "
          f"{json.dumps(bench.diagnostics(tracker))}")
    print(f"{name} sequence time by stage (host clock, StageTimer): "
          + ", ".join(f"{k} {v['total_s']:.3f} s / {v['count']}"
                      for k, v in timer.summary().items()))
    reset_launch_counts()
    tk, stream, rec, detected = instrumented_run(frames, seq, dev, cfg)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"{name} sequence launches (instrumented run): {counts}")
    print(f"{name} host syncs per process_stream call: {stream[:-1]} "
          f"(finish: {stream[-1]})")
    check_sync_rule(name, rec)
    if save:
        save_sequence_features(save, detected, seq)
    plain, _ = bench.run_once(frames[:SEQ_BOUND_FRAMES], seq.intrinsics, cfg,
                              dev, PLAIN)
    gt = seq.gt_poses[:, :, 3]
    for path, t in (("kernel", tk), ("plain", plain)):
        pre = sequence_stats(t, gt, SEQ_BOUND_FRAMES)
        print(f"{name} {path} path, frames 0..{SEQ_BOUND_FRAMES - 1}: "
              f"{json.dumps(pre)} (bounds {json.dumps(bounds)})")
        check_bounds(f"{name} {path}", pre, bounds)
    return counts


def phase_reference(frames_dev: torch.Tensor, card: str, dev,
                    save: str | None) -> dict:
    """The reference profile: the frontend on frames 8..23 through the
    entry point (launch counts, floors, kernel path against plain path),
    the three kernels against their plain versions at its shapes (the
    extrema winners bit for bit at all 4 octaves, the float32 patch kernels
    at octave 0, 752 x 2496), each timed alone and per call beside its
    bound, frontend frames/s of both paths, and bench-96's reference row
    (sequence_run). Returns the three kernels' launches on the sequence."""
    t_phase = time.perf_counter()
    print(f"reference: {card}")
    cfg = REF_CONFIG
    frontend = SiftFrontend(cfg).to(dev)
    plain = SiftFrontend(cfg, PLAIN).to(dev)
    batch = frames_dev[8:8 + BATCH]
    frontend(batch)
    plain(batch)
    reset_launch_counts()
    feats = frontend(batch)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"reference frontend launches: {launches}")
    for name in FRONTEND_KERNELS:
        check(launches[name] == cfg.pyramid.num_octaves,
              f"reference: {name} launched once per octave")
    for name in ("blur_stack", "l2_2nn", "extrema_score"):
        check(launches[name] == 0, f"reference: {name} not launched")
    feature_floors("reference", feats, cfg, REF_MIN_KEYPOINTS,
                   REF_MIN_MATCHES, 128, H, W)
    compare_paths(feats, plain(batch))
    print("reference: kernel path agrees with the plain path on every frame")

    ss = build_pyramid(batch.float() * (1.0 / 255.0), cfg.pyramid,
                       frontend.bands, resize=frontend.resize)
    check(tuple(ss.dog[0].shape) == (BATCH, 5, 2 * H, 2 * W),
          "reference: octave 0 is the 2x upsample")
    timings = kernel_extrema(ss, cfg.sift.contrast_threshold,
                             cfg.sift.octave_capacity(0),
                             ("extrema_winners",))
    timings.update(kernel_patches(ss, cfg, dev))
    del ss
    for name, r in timings.items():
        alone = ("not measured" if r["kernel_ms"] is None
                 else f"{r['kernel_ms']:.4f} ms")
        print(f"time reference {name}: kernel alone {alone}, call "
              f"{r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, bound "
              f"{r['bound_ms']:.4f} ms ({r['bound_by']})")
    print(f"reference frontend frames/s (median of 8 batches of {BATCH}): "
          f"kernel path {frontend_fps(frontend, frames_dev):.1f}, plain path "
          f"{frontend_fps(plain, frames_dev):.1f}")
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    del frontend, plain
    frames, seq = bench.render_sequence(bench.SEQ_FRAMES + bench.INIT_FRAMES)
    counts = sequence_run("reference", cfg, frames, seq, dev, save,
                          REF_BOUNDS)
    for name in FRONTEND_KERNELS:
        check(counts[name] > 0, f"{name} launched on the reference sequence")
    print(f"reference phase wall time: {time.perf_counter() - t_phase:.1f} s")
    return {n: counts[n] for n in FRONTEND_KERNELS}


# the ORB frontend as `cli run --frontend orb` builds it: 8 levels, 2048
# keypoints, the Hamming matcher
ORB_CONFIG = FAST_CONFIG.replace(frontend="orb")
ORB_MIN_KEYPOINTS = 1500    # per frame (of 2048; 2048 measured, PR 9)
ORB_MIN_MATCHES = 500       # per consecutive pair (of 1024; 680-744)
ORB_CPU_NEAR = 0.95         # card vs CPU: keypoints within 0.5 px, same level
ORB_CPU_HAMMING = (8, 0.98)  # bits, share of matched keypoints within them
# frames 0..55 under ORB_CONFIG: half and twice the JAX package's Tracker
# on the same features (tests/jax_sequence_bounds.py --frontend orb,
# PERF.md PR 9: tracking ok 1.0, ATE 1.4862, 12 keyframes, mean inliers
# 69.87)
ORB_BOUNDS = dict(ok=0.5, ate=2.9724, keyframes=(6, 24),
                  mean_inliers=(34.93, 139.75))


def phase_orb(frames_dev: torch.Tensor, card: str, dev,
              save: str | None) -> None:
    """The ORB frontend on frames 8..23 (floors, frames/s, the card's
    features against the CPU port's on frame 8), then frames 0..55 through
    the tracker (sequence_run against ORB_BOUNDS)."""
    t_phase = time.perf_counter()
    print(f"orb: {card}")
    # the tracker's matcher for ORB's packed descriptors
    cfg = ORB_CONFIG.replace(match=ORB_CONFIG.match.replace(metric="hamming"))
    fe = make_frontend(cfg).to(dev)
    batch = frames_dev[8:8 + BATCH]
    fe(batch)
    reset_launch_counts()
    feats = fe(batch)
    torch.cuda.synchronize()
    print(f"orb frontend launches: {launch_counts()} (no ported kernel on "
          f"this path)")
    check(feats.descriptors.dtype == torch.uint32, "orb: packed descriptors")
    feature_floors("orb", feats, cfg, ORB_MIN_KEYPOINTS, ORB_MIN_MATCHES,
                   cfg.orb.brief_pairs // 32, H, W)
    print(f"orb frontend frames/s (median of 8 batches of {BATCH}): "
          f"{frontend_fps(fe, frames_dev):.1f}")
    cpu = make_frontend(cfg)(batch[:1].cpu())
    kp_c, kp_d = cpu.keypoints, feats.keypoints
    vc, vd = kp_c.valid[0], kp_d.valid[0].cpu()

    def key(kp, v):
        return torch.cat([kp.yx[0].cpu()[v],
                          1e4 * kp.level[0].cpu()[v, None].float()], 1)

    d = torch.cdist(key(kp_c, vc), key(kp_d, vd),
                    compute_mode="donot_use_mm_for_euclid_dist")
    dmin, j = d.min(dim=1)
    near = float((dmin < 0.5).float().mean())
    close = dmin < 1e-3
    # unpacked first: torch has no indexing kernel for uint32 everywhere
    bits = (engine.float_desc(cpu.descriptors[0])[vc][close]
            != engine.float_desc(feats.descriptors[0].cpu())[vd][j[close]])
    ham = bits.sum(1).float()
    within = float((ham <= ORB_CPU_HAMMING[0]).float().mean())
    print(f"orb card vs CPU port on frame 8: {int(vc.sum())} vs "
          f"{int(vd.sum())} keypoints, {near:.4f} within 0.5 px at the same "
          f"level, Hamming distance of coincident keypoints median "
          f"{float(ham.median()):g}, max {float(ham.max()):g}, "
          f"{within:.4f} within {ORB_CPU_HAMMING[0]} bits")
    check(abs(int(vc.sum()) - int(vd.sum())) <= 0.02 * int(vc.sum()),
          "orb: card and CPU keypoint counts within 2%")
    check(near >= ORB_CPU_NEAR, "orb: card keypoints match the CPU port's")
    check(float(ham.median()) == 0 and within >= ORB_CPU_HAMMING[1],
          "orb: card descriptors match the CPU port's")
    del fe
    frames, seq = bench.render_sequence(SEQ_BOUND_FRAMES)
    sequence_run("orb", ORB_CONFIG, frames, seq, dev, save, ORB_BOUNDS)
    print(f"orb phase wall time: {time.perf_counter() - t_phase:.1f} s")


HARRIS_CONFIG = DEFAULT_CONFIG.replace(frontend="harris")  # cli detect's
HARRIS_MIN_KEYPOINTS = 800  # per frame (of 1024; 1024 measured, PR 9)
FIVE_POINT_ROT_DEG = 0.5    # frames 0 -> 8 against ground truth
# Sampson threshold of the two-view check: ~(1 px / f)^2 at f = 748.8 (the
# tracker's 1.5e-3 admits ~29 px and leaves the 8-point pose ~1 degree off
# on these 149 matches in a CPU rehearsal)
TWO_VIEW_SAMPSON = 2e-6


def phase_harris_5pt(frames_dev: torch.Tensor, frontend: SiftFrontend,
                     seq: SyntheticSequence, card: str, dev) -> None:
    """The Harris frontend as `cli detect --frontend harris` runs it on
    frames 8..23 (floors, unit descriptors, frames/s), and two-view
    relative pose of frames 0 and 8 (FAST_CONFIG's SIFT features, its
    matcher) with the five-point and the eight-point RANSAC: each
    rotation against ground truth, inliers, time and host syncs."""
    t_phase = time.perf_counter()
    print(f"harris_5pt: {card}")
    fe = make_frontend(HARRIS_CONFIG).to(dev)
    batch = frames_dev[8:8 + BATCH]
    feats = fe(batch)
    feature_floors("harris", feats, HARRIS_CONFIG, HARRIS_MIN_KEYPOINTS, 0,
                   256, H, W)
    norms = torch.linalg.vector_norm(feats.descriptors, dim=-1)
    check(bool(((norms - 1).abs() < 1e-4)[feats.keypoints.valid].all()),
          "harris: unit descriptors")
    print(f"harris frontend frames/s (median of 8 batches of {BATCH}): "
          f"{frontend_fps(fe, frames_dev):.1f}")
    fa, fb, intr, R_rel = two_view_pair(frames_dev, frontend, seq, dev)
    for solver, N in (("5pt", 128), ("8pt", 512)):
        cfg = two_view_config(solver, N)

        def solve():
            return two_view_from_features(fa, fb, intr, cfg,
                                          generator(cfg.ransac.seed, dev))

        res = solve()
        err = float(rot_deg(res.R.cpu().numpy()[None], R_rel[None])[0])
        ms = wall_ms(solve, 5)
        syncs = count_syncs(solve)
        print(f"two-view frames 0 -> 8, {solver} RANSAC ({N} hypotheses): "
              f"rotation error {err:.4f} deg, {int(res.num_inliers)} inliers "
              f"of {int(res.matches.count())} matches, {ms:.2f} ms per call, "
              f"{syncs} host syncs per call")
        check(err <= FIVE_POINT_ROT_DEG,
              f"{solver}: rotation within {FIVE_POINT_ROT_DEG} deg")
        two_view_programs(solver, cfg, fa, fb, frames_dev[[0, 8]], intr,
                          R_rel, dev)
    print(f"harris_5pt phase wall time: "
          f"{time.perf_counter() - t_phase:.1f} s")


def _same(a, b) -> bool:
    """Every tensor of two results equal, bit for bit."""
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _capture_line(what: str, key) -> str:
    if key is None:
        return f"{what} not captured"
    return (f"{what} captured in {key.capture_s:.3f} s (warm-up included), "
            f"static buffers and graph pool {key.pool_bytes / 2 ** 20:.1f} "
            f"MiB")


def two_view_programs(solver: str, cfg, fa, fb, imgs, intr, R_rel,
                      dev) -> None:
    """The tracker's "ransac" program and two_view_reconstruction_jit on
    frames 0 -> 8 against their eager kernel-path functions, bit for bit
    for two seeds in turn and the first again (R, t, X, inliers, count;
    the two-view result's matches too), each replay's random draws against
    the eager sample_indices, 0 host syncs per replay; ms per call of the
    graph, the eager kernel path and the plain path (host clock); the
    captures' seconds and bytes; the plain path's rotation against ground
    truth under the same bound as the kernel path's."""
    t0 = time.perf_counter()
    seed = cfg.ransac.seed
    m = match_features(fa, fb, cfg.match)
    x = (normalized(fa.keypoints.yx[m.idx_a.long()].flip(-1), intr),
         normalized(fb.keypoints.yx[m.idx_b.long()].flip(-1), intr), m.valid)
    prog = slam_tracker._shared_programs(cfg)["ransac"]
    rcfg = (cfg.ransac, KERNELS)
    # capture with the sampler kept: its last output is the graph's own
    # buffer of draws, which every replay rewrites
    draws, real = [], trs.sample_indices

    def keep(gen, valid, n_hyp, n):
        draws.append(real(gen, valid, n_hyp, n))
        return draws[-1]

    trs.sample_indices = keep
    try:
        prog(x, rcfg, seed)
    finally:
        trs.sample_indices = real
    check(len(prog.captured) == 1 and len(draws) == 2,
          f"{solver}: the ransac program captured once")
    n_draw = cfg.ransac.sample_size if solver == "8pt" else 5
    rows = []
    for s_ in (seed, seed + 1, seed):
        got = []
        syncs = count_syncs(lambda: got.append(prog(x, rcfg, s_)))
        want = trs.estimate_relative_pose(*x, cfg.ransac, generator(s_, dev),
                                          KERNELS)
        same_draws = torch.equal(draws[-1], real(
            generator(s_, dev), x[2], cfg.ransac.num_hypotheses, n_draw))
        rows.append((s_, _same(got[0], want), same_draws, syncs))
    print(f"two-view {solver}: the ransac program against the eager "
          f"estimate_relative_pose (seed, equal bit for bit, draws equal, "
          f"host syncs per replay): {rows}; "
          + _capture_line("ransac program", next(iter(
              prog.captured.values()), None)))
    check(all(r[1] and r[2] and r[3] == 0 for r in rows),
          f"{solver}: the ransac program replays the eager function and "
          "its draws bit for bit, with no host sync")
    graph_ms = wall_ms(lambda: prog(x, rcfg, seed), 10)
    eager_ms = wall_ms(lambda: trs.estimate_relative_pose(
        *x, cfg.ransac, generator(seed, dev), KERNELS), 10)
    plain_ms = wall_ms(lambda: trs.estimate_relative_pose(
        *x, cfg.ransac, generator(seed, dev), PLAIN), 5)
    print(f"two-view {solver} ransac program: {graph_ms:.3f} ms per call "
          f"(graph), {eager_ms:.3f} eager kernel path, {plain_ms:.3f} plain "
          f"path (host clock + synchronize)")

    rows = []
    for s_ in (seed, seed + 1, seed):
        got = two_view_reconstruction_jit(imgs[0], imgs[1], intr, cfg, s_)
        want = two_view_reconstruction(imgs[0], imgs[1], intr, cfg,
                                       generator(s_, dev))
        rows.append((s_, _same(got, want)))
    tv = two_view_from_features_jit.program
    syncs = count_syncs(lambda: two_view_from_features_jit(fa, fb, intr, cfg,
                                                           seed))
    print(f"two-view {solver}: two_view_reconstruction_jit against the eager "
          f"two_view_reconstruction (seed, every field equal bit for bit): "
          f"{rows}; host syncs per replay of two_view_from_features_jit "
          f"{syncs}; " + _capture_line("its graph", next(iter(
              reversed(tv.captured.values())), None)))
    check(all(r[1] for r in rows) and syncs == 0,
          f"{solver}: two_view_reconstruction_jit equals the eager function "
          "bit for bit, with no host sync in its replay")
    graph_ms = wall_ms(lambda: two_view_from_features_jit(fa, fb, intr, cfg,
                                                          seed), 10)
    eager_ms = wall_ms(lambda: two_view_from_features(
        fa, fb, intr, cfg, generator(seed, dev)), 10)
    plain = two_view_from_features(fa, fb, intr, cfg, generator(seed, dev),
                                   PLAIN)
    plain_ms = wall_ms(lambda: two_view_from_features(
        fa, fb, intr, cfg, generator(seed, dev), PLAIN), 5)
    err = [float(rot_deg(r.R.cpu().numpy()[None], R_rel[None])[0])
           for r in (got, plain)]
    print(f"two-view {solver} from features: {graph_ms:.3f} ms per call "
          f"(graph), {eager_ms:.3f} eager kernel path, {plain_ms:.3f} plain "
          f"path; rotation error kernel path {err[0]:.4f} deg "
          f"({int(got.num_inliers)} inliers), plain path {err[1]:.4f} deg "
          f"({int(plain.num_inliers)} inliers); wall time "
          f"{time.perf_counter() - t0:.1f} s")
    check(max(err) <= FIVE_POINT_ROT_DEG, f"{solver}: kernel and plain "
          f"paths' rotations within {FIVE_POINT_ROT_DEG} deg")


# the harness phase: `cli benchmark`'s per-stage rows (harness.py) on the
# card; it must leave the JAX package's committed results untouched
JAX_RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "benchmarks", "results.json")


def phase_harness(card: str) -> dict:
    """harness.run_benchmarks on the card (DEFAULT_CONFIG, 376x1248; the
    kernels are built): every row finite and positive, the frontend
    kernels launched (the SIFT row is the only one that runs them: the
    pyramid row blurs with banded products and the match row is the dense
    matcher), benchmarks/results.json byte for byte as before. Returns
    the kernels' launches over the harness."""
    from visualslam_tpu_torch.harness import run_benchmarks

    t_phase = time.perf_counter()
    print(f"harness: {card}")
    before = open(JAX_RESULTS, "rb").read()
    reset_launch_counts()
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "HARNESS_TORCH.json")
        rows = run_benchmarks(device="cuda", out=out)
        written = json.load(open(out))
    counts = launch_counts()
    for k, v in rows.items():
        print(f"harness {k}: {v:.4f} ({card})")
    print(f"harness launches: {counts}")
    check(written["device"] == card, "harness: the card named in its JSON")
    check(len(rows) == 9 and all(np.isfinite(v) and v > 0
                                 for v in rows.values()),
          "harness: every row finite and positive")
    for name in FRONTEND_PATH:
        check(counts[name] > 0, f"harness: {name} launched in the SIFT row")
    for name in ("blur_stack", "l2_2nn", "extrema_score"):
        check(counts[name] == 0, f"harness: {name} not launched under "
              "DEFAULT_CONFIG")
    check(open(JAX_RESULTS, "rb").read() == before,
          "harness: benchmarks/results.json unchanged")
    print(f"harness phase wall time: {time.perf_counter() - t_phase:.1f} s")
    return counts


# the full_sequence phase: kitti_scale.run, the port's KITTI-scale protocol
# (benchmarks/kitti_scale.py's), with this phase's measurements added at
# its hook points
KS_FRAMES = kitti_scale.FRAMES
KS_WORLD = kitti_scale.WORLD
KS_CONFIG = kitti_scale.CONFIG
# Bands: half / twice the JAX package's own figures on this protocol
# (benchmarks/kitti_scale.json: 80 keyframes, 1 loop closure, ATE 5.1663
# after global BA). These are accuracy figures on the reference's own
# features, not speed figures; no speed figure of that file is used.
KS_OK = 0.9                 # tracking-ok share
KS_KEYFRAMES = (40, 160)    # and more than 64: global BA goes matrix-free
KS_MF_CAMERAS = 64
KS_LOOPS = 1
KS_ATE_GBA = 2 * 5.1663
KS_ATE_VS_TRACKED = 1.05    # global BA no worse than the tracked ATE
# cg / mf final costs on one problem, at the configuration's 32 CG
# iterations, against the same 10-step LM run in float64 with the dense
# solve: only the first camera is fixed, so the reduced system is singular
# along the monocular scale gauge (damped by lambda alone, which falls to
# its 1e-9 floor); the truncated CG solves and the run-dependent sums part
# the LM paths a little. Measured over five runs (PERF.md, PR 8): schur_cg
# up to 2.28e-3 relative to the float32 dense solve, schur_mf up to
# 2.84e-3. The float32 dense solve is no reference: its LU at lambda 1e-9
# is noise along the gauge, so a repeat on the same problem may lose LM
# steps (the repeats print its spread). A solver fault moves the cost by
# orders of magnitude (it falls 100-fold here). Running the CG longer does
# not tighten this: in float32 the 1e-10 stop test never fires, and at
# 200 iterations schur_cg drifted 1.16%.
KS_SOLVER_RTOL = 1e-2
KS_SOLVER_REPS = 8           # runs of each solver on the problem
KS_RESUME_RTOL = 1e-3       # resumed vs original global-BA cost (equal
#                             bits expected: fixed-order sums)
KS_POSE_FILE_TOL = 1e-6     # ATE from the pose file vs in memory


def state_diffs(a, b) -> list:
    """Names of the tracker state that differs between a and b, bit for
    bit: every map array, observation, archive entry and frame result, the
    host mirrors and the engine persist (database rings up to the live
    entry count: past it the ring holds no state, and the checkpoint
    slices it off)."""
    diffs = []

    def eq(name, x, y):
        if torch.is_tensor(x):
            ok = x.dtype == y.dtype and x.shape == y.shape and bool(
                torch.equal(x, y))
        else:
            x, y = np.asarray(x), np.asarray(y)
            ok = x.dtype == y.dtype and np.array_equal(x, y)
        if not ok:
            diffs.append(name)

    ma, mb = a.map, b.map
    for n in ("kf_R", "kf_t", "kf_valid", "kf_frame_id", "kf_order", "X",
              "lm_valid", "lm_obs_count", "lm_uid", "_next_uid",
              "_lm_cursor"):
        eq(f"map.{n}", getattr(ma, n), getattr(mb, n))
    for s in range(ma.window):
        eq(f"map.kf_kp_lm[{s}]", ma.kf_kp_lm[s], mb.kf_kp_lm[s])
        for n in ("kf_desc", "kf_yx", "kf_kp_valid"):
            x, y = getattr(ma, n)[s], getattr(mb, n)[s]
            if (x is None) != (y is None):
                diffs.append(f"map.{n}[{s}]")
            elif x is not None:
                eq(f"map.{n}[{s}]", x, y)
    if sorted(ma.obs) != sorted(mb.obs):
        diffs.append("map.obs slots")
    for s in ma.obs:
        for k, (x, y) in enumerate(zip(ma.obs[s], mb.obs.get(s, ()))):
            eq(f"map.obs[{s}][{k}]", x, y)
    if len(ma.archive) != len(mb.archive):
        diffs.append("map.archive")
    for k, (x, y) in enumerate(zip(ma.archive, mb.archive)):
        for n in ("frame_id", "R", "t", "lm_uid", "uv"):
            eq(f"map.archive[{k}].{n}", getattr(x, n), getattr(y, n))
    if sorted(ma.archived_lm_pos) != sorted(mb.archived_lm_pos):
        diffs.append("map.archived_lm_pos")
    for u, x in ma.archived_lm_pos.items():
        eq(f"map.archived_lm_pos[{u}]", x, mb.archived_lm_pos.get(u))
    if len(a.frames) != len(b.frames):
        diffs.append("frames")
    for k, (x, y) in enumerate(zip(a.frames, b.frames)):
        for n in ("frame_id", "R", "t", "num_matches", "num_inliers",
                  "is_keyframe", "tracking_ok"):
            eq(f"frames[{k}].{n}", getattr(x, n), getattr(y, n))
    for n in ("_last_R", "_last_t", "_vel", "_frames_since_kf", "_eng_ids",
              "_eng_uids", "_eng_gen", "_eng_db_n"):
        eq(n, getattr(a, n), getattr(b, n))
    n_db = a._eng_db_n
    for n in engine.EnginePersist._fields:
        x, y = getattr(a._eng_persist, n), getattr(b._eng_persist, n)
        if n.startswith("db_") and n != "db_n":
            x, y = x[:n_db], y[:n_db]
        eq(f"persist.{n}", x, y)
    la, lb = a.loop_closer, b.loop_closer
    if [e.frame_id for e in la.entries] != [e.frame_id for e in lb.entries]:
        diffs.append("loop entries")
    for k, (x, y) in enumerate(zip(la.entries, lb.entries)):
        eq(f"loop entry {k}.R", x.R, y.R)
        eq(f"loop entry {k}.t", x.t, y.t)
    if len(la.loop_edges) != len(lb.loop_edges):
        diffs.append("loop edges")
    if (la.corrected is None) != (lb.corrected is None):
        diffs.append("loop corrected")
    elif la.corrected is not None:
        for k, ((Ra, ta), (Rb, tb)) in enumerate(zip(la.corrected,
                                                     lb.corrected)):
            eq(f"loop corrected {k}.R", Ra, Rb)
            eq(f"loop corrected {k}.t", ta, tb)
    return diffs


class LoopParts:
    """A tracker's loop_optimize stage split in parts: `wait` (the work
    already queued on the device, drained by a synchronize before each
    timed call), `pose_graph` (the loop closer's program, from the call
    until its result is ready), `db_correct` (the engine's database
    correction, likewise) and, by difference from the stage's total,
    `host` (the loop closer's numpy assembly and corrections, the window's
    correction). Wraps the tracker's loop-closer program and its
    db_correct; keeps the first pose-graph call's graph, cfg and result."""

    PARTS = ("wait", "pose_graph", "db_correct")

    def __init__(self, tracker):
        self.s = dict.fromkeys(self.PARTS, 0.0)
        self.calls = 0
        self.first = None
        lc = tracker.loop_closer
        prog, db = lc.program, tracker._eng_progs["db_correct"]

        def timed(part, fn):
            def call(*a):
                t0 = time.perf_counter()
                torch.cuda.synchronize()
                t1 = time.perf_counter()
                out = fn(*a)
                torch.cuda.synchronize()
                self.s["wait"] += t1 - t0
                self.s[part] += time.perf_counter() - t1
                return out
            return call

        timed_pg = timed("pose_graph", prog)

        def program(g, cfg):
            out = timed_pg(g, cfg)
            self.calls += 1
            if self.first is None:
                self.first = (g, cfg, out)
            return out

        program.prepare = prog.prepare
        lc.program = program
        tracker._eng_progs = dict(tracker._eng_progs,
                                  db_correct=timed("db_correct", db))

    def split(self, timer: StageTimer) -> dict:
        """{part: seconds} over the run, the stage's total and its count."""
        st = timer.summary().get("loop_optimize",
                                 {"total_s": 0.0, "count": 0})
        out = dict(self.s, host=st["total_s"] - sum(self.s.values()))
        return dict(out, total=st["total_s"], count=st["count"],
                    pose_graph_calls=self.calls)


def print_split(name: str, split: dict) -> None:
    n = max(split["pose_graph_calls"], 1)
    print(f"{name} loop_optimize split ({split['count']} closures, "
          f"{split['total']:.3f} s): pose-graph program "
          f"{split['pose_graph']:.3f} s ({1e3 * split['pose_graph'] / n:.1f}"
          f" ms per optimize), db_correct {split['db_correct']:.3f} s, wait "
          f"for queued device work {split['wait']:.3f} s, host work "
          f"{split['host']:.3f} s")


def solver_program_check(what: str, prog, x, cfg, ran=None) -> None:
    """A solver program (utils/graphs.LoopProgram) against its eager
    function on x: equal bit for bit (and `ran`, the program's result in
    the run, likewise), ms per call graph (median of 3) / eager (the one
    compared: a pose graph's eager solve takes seconds), host launch
    calls, device kernels and busy of one call each, host syncs inside a
    warm replay (0), and the key's capture seconds and bytes."""
    got = prog(x, cfg)
    graphs = prog.captured[(_signature(x), cfg)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eager = prog.fn(x, cfg)
    torch.cuda.synchronize()
    ms_e = 1e3 * (time.perf_counter() - t0)
    same = all(torch.equal(a, b) for a, b in zip(_leaves(got),
                                                 _leaves(eager)))
    if ran is not None:
        same = same and all(torch.equal(a, b) for a, b in
                            zip(_leaves(ran), _leaves(eager)))
    ms = wall_ms(lambda: prog(x, cfg), 3)
    syncs = count_syncs(lambda: prog(x, cfg))
    k, busy, _, host = profile_launches(lambda: prog(x, cfg))
    k_e, busy_e, _, host_e = profile_launches(lambda: prog.fn(x, cfg))
    print(f"{what} ({prog.__name__}, {x.R.shape[0]} nodes, "
          f"{x.i.shape[0]} edges, {cfg.iters} LM iterations, solver "
          f"{resolve_solver(cfg, x.R.shape[0])}, cost "
          f"{float(eager.initial_cost):.6e} -> {float(eager.cost):.6e}): "
          f"equal bit for bit {same}; ms per optimize graph {ms:.3f} / "
          f"eager {ms_e:.3f}; host launch calls {host} / {host_e}; device "
          f"kernels {k} / {k_e}; device busy {busy} / {busy_e} ms; host "
          f"syncs inside a replay {syncs}; capture {graphs.capture_s:.3f} "
          f"s, {graphs.pool_bytes / 2 ** 20:.1f} MiB")
    check(same, f"{what}: the program equals the eager solve bit for bit")
    check(syncs == 0, f"{what}: a replay makes no host sync")


def synthetic_se3_graph(dev) -> tuple:
    """(an SE(3) loop closer at KS_CONFIG's pose-graph settings, the
    padded graph it builds for a drifting loop of 60 keyframes with one
    loop edge: 256 nodes, 1024 edges)."""
    from visualslam_tpu_torch.slam.loop_closure import LoopCloser

    lc = LoopCloser(np.eye(3, dtype=np.float32), KS_CONFIG.match,
                    KS_CONFIG.pose_graph, use_sim3=False, device=dev)
    r = np.random.default_rng(0)
    n = 60
    ang = np.linspace(0, 2 * np.pi * (n - 1) / n, n)
    R = se3.exp_so3(torch.tensor(np.stack(
        [np.zeros(n), -ang, np.zeros(n)], 1), dtype=torch.float32)).numpy()
    c = np.stack([10 * np.sin(ang), np.zeros(n), 10 * np.cos(ang) - 10], 1)
    t = -np.einsum("nij,nj->ni", R, c).astype(np.float32)
    ii, jj = list(range(n - 1)) + [0], list(range(1, n)) + [n - 1]
    Rm = [R[a].T @ R[b] for a, b in zip(ii, jj)]
    tm = [R[a].T @ (t[b] - t[a]) + (r.normal(0, 0.05, 3) if a + 1 == b
                                     else 0.0) for a, b in zip(ii, jj)]
    t_drift = (t + r.normal(0, 0.1, t.shape)).astype(np.float32)
    g = lc._graph(*lc._capacity(n), R, t_drift, ii, jj, Rm, tm,
                  [1.0] * len(ii), [1.0] * len(ii))
    return lc, g


class FullSequenceHooks(kitti_scale.Hooks):
    """The full_sequence phase's measurements inside kitti_scale.run: the
    stage timer, launch counts and host syncs of the timed stream, the
    stream's checks and the checkpoint round trip before the global BA,
    the deterministic global-BA comparison after it."""

    def __init__(self, card: str, dev):
        self.card, self.dev = card, dev
        self.calls = []

    def stream(self, tracker):
        self.timer = tracker.timer = StageTimer()
        # the keys prewarm_aux prepared: the closures replay them
        self.pg_prog = tracker.loop_closer.program
        self.pg_keys = list(self.pg_prog.captured)
        self.loop = LoopParts(tracker)
        reset_launch_counts()
        self.rec = SyncRecorder()
        return self.rec

    def step(self, call):
        s0 = self.rec.syncs()
        call()
        self.calls.append(self.rec.syncs() - s0)

    def tracked(self, tracker):
        tracker.timer = None
        self.counts = launch_counts()
        rules = self.rec.rules()
        stream, timer = self.calls, self.timer
        print(f"full_sequence time by stage (host clock, StageTimer): "
              + ", ".join(f"{k} {v['total_s']:.3f} s / {v['count']}"
                          for k, v in timer.summary().items()))
        self.split = self.loop.split(timer)
        print(f"full_sequence pose-graph program keys: prepared by "
              f"prewarm_aux {len(self.pg_keys)}, after the stream "
              f"{len(self.pg_prog.captured)}")
        check(self.pg_keys and set(self.pg_prog.captured)
              == set(self.pg_keys), "the closures replayed the pose-graph "
              "program prewarm_aux prepared (no capture in the timed "
              "stream)")
        print(f"full_sequence launches over the stream: "
              f"{ {n: self.counts[n] for n in FRONTEND_PATH} }")
        for name in FRONTEND_PATH:
            check(self.counts[name] > 0,
                  f"{name} launched on the full sequence")
        print(f"full_sequence host syncs per process_stream call: "
              f"{stream[:-1]} (finish: {stream[-1]})")
        broke = [(i, r) for i, r in enumerate(rules) if r[0] != r[1]]
        print(f"full_sequence engine batches: {len(rules)}, promotions "
              f"{sum(r[2] for r in rules)}; batches off the sync rule "
              f"(index, (syncs, active, promotions)): {broke}; batches "
              f"that captured the graphs: {self.rec.captures()}")
        check(not broke, "every engine batch syncs once per active frame "
              "and never per promotion, through the closures")
        check(len(tracker.frames) == KS_FRAMES and [f.frame_id for f in
              tracker.frames] == list(range(KS_FRAMES)),
              "full_sequence: every frame committed once")
        self.ok = float(np.mean([f.tracking_ok for f in tracker.frames]))
        kf_ids = [f.frame_id for f in tracker.frames if f.is_keyframe]
        gaps = np.bincount(np.diff(kf_ids))
        print(f"full_sequence tracking-ok share {self.ok:.4f}; keyframe "
              f"gaps (frames: count): "
              f"{ {g: int(n) for g, n in enumerate(gaps) if n} }")

        # checkpoint round trip, before global BA touches the frame results
        from visualslam_tpu_torch.slam.checkpoint import (
            load_checkpoint,
            save_checkpoint,
        )

        with tempfile.TemporaryDirectory() as tmp:
            ckpt = os.path.join(tmp, "slam_ckpt.npz")
            t0 = time.perf_counter()
            save_checkpoint(ckpt, tracker)
            t_save = time.perf_counter() - t0
            self.resumed = Tracker(KS_CONFIG, tracker.intr.cpu().numpy(),
                                   device=self.dev)
            t0 = time.perf_counter()
            load_checkpoint(ckpt, self.resumed)
            t_load = time.perf_counter() - t0
            size = os.path.getsize(ckpt)
        diffs = state_diffs(tracker, self.resumed)
        print(f"full_sequence checkpoint: {size / 2 ** 20:.1f} MiB, save "
              f"{t_save:.2f} s, load {t_load:.2f} s; state that differs "
              f"after the round trip: {diffs[:10]}")
        check(not diffs, "the checkpoint round trip restores the state bit "
              "for bit")

    def global_ba(self, tracker, res):
        # the resumed tracker's global BA against the same solve on the
        # original's state, in the default mode (the segment sums add in a
        # fixed order on the card)
        from visualslam_tpu_torch.slam.global_ba import run_global_ba

        self.res = res
        lc = tracker.loop_closer
        corrected = None if lc.corrected is None else {
            int(e.frame_id): (np.asarray(R), np.asarray(t))
            for e, (R, t) in zip(lc.entries, lc.corrected)}
        res_o = run_global_ba(tracker.map, KS_CONFIG.ba, corrected,
                              device=self.dev)
        res_r = self.resumed.global_ba()
        del self.resumed
        print(f"full_sequence global BA: {res.n_cameras} cameras, "
              f"{res.n_landmarks} landmarks, {res.n_observations} "
              f"observations, cost {res.initial_cost:.6e} -> "
              f"{res.cost:.6e}; default mode, original "
              f"{res_o.n_cameras} / {res_o.n_landmarks} / "
              f"{res_o.n_observations}, cost {res_o.initial_cost:.9e} -> "
              f"{res_o.cost:.9e}, resumed {res_r.n_cameras} / "
              f"{res_r.n_landmarks} / {res_r.n_observations}, cost "
              f"{res_r.initial_cost:.9e} -> {res_r.cost:.9e} (equal bits: "
              f"{res_r.cost == res_o.cost})")
        check((res_r.n_cameras, res_r.n_landmarks, res_r.n_observations)
              == (res.n_cameras, res.n_landmarks, res.n_observations)
              == (res_o.n_cameras, res_o.n_landmarks, res_o.n_observations)
              and abs(res_r.cost - res_o.cost)
              <= KS_RESUME_RTOL * res_o.cost,
              "the resumed tracker's global BA matches the original's")
        # the keys the warm global BA must find: it replays the cold one's
        self.ba_keys = list(run_ba_jit.captured)


class StageHooks(kitti_scale.Hooks):
    """A stage timer and the loop_optimize split on the timed stream,
    nothing else."""

    def stream(self, tracker):
        self.timer = tracker.timer = StageTimer()
        self.loop = LoopParts(tracker)
        return contextlib.nullcontext()


def eager_kitti_run(seq, frames, warm_seq, wf, dev) -> tuple:
    """kitti_scale.run on the same frames with EagerTracker (the eager
    engine batch and pose graph) and the eager run_ba for the global BA.
    Returns (its result dict, engine_dispatch seconds, the loop_optimize
    split)."""
    from visualslam_tpu_torch.backend import ba as ba_module
    from visualslam_tpu_torch.slam import global_ba as global_ba_module
    from visualslam_tpu_torch.slam import tracker as tracker_module

    hooks = StageHooks()
    tracker_module.Tracker = EagerTracker
    global_ba_module.run_ba_jit = ba_module.run_ba_jit = EagerProgram(
        run_ba_jit)
    try:
        out, tracker = kitti_scale.run(seq, frames, warm_seq, wf, dev, hooks)
    finally:
        tracker_module.Tracker = Tracker
        global_ba_module.run_ba_jit = ba_module.run_ba_jit = run_ba_jit
    check(type(tracker) is EagerTracker, "the eager KITTI-scale run took "
          "the eager tracker")
    del tracker
    return (out, hooks.timer.summary()["engine_dispatch"]["total_s"],
            hooks.loop.split(hooks.timer))


def phase_full_sequence(card: str, dev) -> tuple:
    """The port's KITTI-scale protocol (kitti_scale.run, not cut): 500
    frames of 376x1248 on the loop rectangle (12000 dots), FAST_CONFIG
    with the matrix-free BA, a warmup tracker on 24 frames of another
    seed, process_batch of frames 0..7, process_stream in batches of 16 +
    finish (timed; host syncs counted), then the full-sequence global BA
    (cold, then the rebuilt problem warm); this phase adds the checkpoint
    round trip, the deterministic global-BA comparison, the three BA
    solvers on the rebuilt problem against its float64 dense LM run and
    the pose file. Returns the three frontend kernels' launches over the
    stream, and the tracker."""
    from visualslam_tpu_torch.io.serialization import (
        load_kitti_poses,
        save_kitti_poses,
    )
    from visualslam_tpu_torch.slam.evaluation import centers_from_poses
    from visualslam_tpu_torch.slam.global_ba import (
        build_global_problem,
        global_run_cfg,
    )

    t_phase = time.perf_counter()
    print(f"full_sequence: {card}")
    seq, frames, warm_seq, wf = kitti_scale.render(KS_FRAMES)
    print(f"full_sequence frames: {frames.shape} uint8 rendered")
    gt = seq.gt_poses
    hooks = FullSequenceHooks(card, dev)
    out, tracker = kitti_scale.run(seq, frames, warm_seq, wf, dev, hooks)
    res = hooks.res
    print(f"full_sequence frames/s ({card}): {out['sequence_fps']} "
          f"({KS_FRAMES - kitti_scale.INIT} frames of process_stream in "
          f"batches of {kitti_scale.BATCH} + finish, "
          f"{out['track_wall_s']} s, host clock + synchronize, sync debug "
          f"mode on)")
    print(f"full_sequence KITTI-scale result: {json.dumps(out)}")
    ate_track, ate_gba = out["ate_tracked_m"], out["ate_after_gba_m"]
    n_kf = out["keyframes"]
    graph_dispatch = hooks.timer.summary()["engine_dispatch"]["total_s"]
    eager_out, eager_dispatch, eager_split = eager_kitti_run(
        seq, frames, warm_seq, wf, dev)
    print(f"full_sequence engine_dispatch ({card}): graph path "
          f"{graph_dispatch:.3f} s, eager path {eager_dispatch:.3f} s over "
          f"{KS_FRAMES - kitti_scale.INIT} streamed frames; sequence frames/s "
          f"{out['sequence_fps']} / {eager_out['sequence_fps']} (the graph "
          f"run with sync debug mode on); keyframes {n_kf} / "
          f"{eager_out['keyframes']}, loop closures {out['loop_closures']} / "
          f"{eager_out['loop_closures']}, tracked ATE {ate_track} / "
          f"{eager_out['ate_tracked_m']}")

    print_split("full_sequence graph path", hooks.split)
    print_split("full_sequence eager path", eager_split)
    # the first closure's padded Sim(3) graph, and a synthetic SE(3) graph
    # padded as the loop closer pads it, through the programs and eagerly
    check(hooks.loop.first is not None, "full_sequence: the loop closer "
          "ran its pose-graph program")
    if hooks.loop.first is not None:
        g1, pg_cfg, run_res = hooks.loop.first
        solver_program_check("full_sequence first closure's pose graph",
                             hooks.pg_prog, g1, pg_cfg, run_res)
    lc_se3, g_se3 = synthetic_se3_graph(dev)
    solver_program_check("synthetic SE(3) pose graph", lc_se3.program,
                         g_se3, lc_se3.pg_cfg)

    # the global BA: cold (with the capture) and warm through run_ba_jit
    gba, gba_e = out["global_ba"], eager_out["global_ba"]
    print(f"full_sequence global BA wall s (kitti_scale: build, solve, "
          f"read-back), graph path run_ba_jit cold with its capture "
          f"{gba['wall_s_cold_incl_compile']} / warm {gba['wall_s_warm']}; "
          f"eager run_ba cold {gba_e['wall_s_cold_incl_compile']} / warm "
          f"{gba_e['wall_s_warm']}")
    check(list(run_ba_jit.captured) == hooks.ba_keys, "the warm global BA "
          "replayed the cold call's program (no capture)")
    # the rebuilt problem (as kitti_scale.run rebuilds it), warm
    p2, _ = build_global_problem(tracker.map, device=dev)
    base = global_run_cfg(KS_CONFIG.ba, p2)
    check(base.solver == "schur_mf", "the rebuilt problem takes schur_mf")
    warm_ms = wall_ms(lambda: run_ba_jit(p2, base), 3)
    eager_ms = wall_ms(lambda: run_ba(p2, base), 3)
    syncs = count_syncs(lambda: run_ba(p2, base))
    replay_syncs = count_syncs(lambda: run_ba_jit(p2, base))
    launches, busy, _, host = profile_launches(lambda: run_ba(p2, base))
    g_launches, g_busy, _, g_host = profile_launches(
        lambda: run_ba_jit(p2, base))
    same = all(torch.equal(a, b) for a, b in zip(run_ba_jit(p2, base),
                                                 run_ba(p2, base)))
    reset_launch_counts()
    run_ba_jit(p2, base)
    seg = launch_counts()["segment_sum"]
    print(f"full_sequence global BA warm (schur_mf, rebuilt problem C = "
          f"{p2.R.shape[0]}, L = {p2.X.shape[0]}, O = {p2.uv.shape[0]}): "
          f"{warm_ms:.3f} ms per run_ba_jit against {eager_ms:.3f} ms per "
          f"eager run_ba ({warm_ms / base.iters:.3f} / "
          f"{eager_ms / base.iters:.3f} ms per LM iteration, median of 3); "
          f"equal bit for bit {same}; host syncs inside a replay "
          f"{replay_syncs}, inside run_ba {syncs}; host launch calls "
          f"{g_host} / {host}; device kernels {g_launches} / {launches}, "
          f"device busy {g_busy} / {busy} ms; {seg} segment_sum launches "
          f"per replayed solve")
    check(same, "the warm global BA's replay equals the eager run_ba bit "
          "for bit")
    check(replay_syncs == 0, "a global BA replay makes no host sync")
    check(seg > 0, "the global BA's segment sums launch the kernel")
    # the exact LM path: the same problem and steps in float64, dense
    p64 = p2._replace(R=p2.R.double(), t=p2.t.double(), X=p2.X.double(),
                      uv=p2.uv.double())
    r64 = run_ba(p64, base.replace(solver="schur_dense"))
    c64 = float(r64.cost)
    check(c64 < float(r64.initial_cost), "the float64 dense LM lowers the "
          "rebuilt problem's cost")
    costs, rel, ms, same = {}, {}, {}, {}
    for solver in ("schur_dense", "schur_cg", "schur_mf"):
        c = base.replace(solver=solver)
        ms[solver] = wall_ms(lambda: run_ba_jit(p2, c), 2)
        reps = [run_ba_jit(p2, c) for _ in range(KS_SOLVER_REPS)]
        reps.append(run_ba(p2, c))
        costs[solver] = [float(r.cost) for r in reps[:-1]]
        rel[solver] = [abs(x - c64) / c64 for x in costs[solver]]
        same[solver] = all(torch.equal(a, b) for r in reps[1:]
                           for a, b in zip(reps[0], r))
        del reps
    print(f"full_sequence solvers on the card, cg_iters {base.cg_iters}, "
          f"initial cost {float(r64.initial_cost):.9e}, float64 dense "
          f"final cost {c64:.9e}; float32 final costs of "
          f"{KS_SOLVER_REPS} runs each through run_ba_jit: "
          f"{json.dumps(costs)}; ms per run_ba_jit: {json.dumps(ms)}; "
          f"relative to the float64 dense: {json.dumps(rel)}; the runs and "
          f"an eager run_ba equal bit for bit (R, t, X, cost, lambda), "
          f"default mode: {json.dumps(same)}")
    for solver in ("schur_dense", "schur_cg", "schur_mf"):
        check(same[solver], f"{solver}: the {KS_SOLVER_REPS} program runs "
              "and the eager run equal bit for bit in the default mode")
    for solver in ("schur_cg", "schur_mf"):
        check(max(rel[solver]) <= KS_SOLVER_RTOL, f"{solver} final cost "
              f"within {KS_SOLVER_RTOL} of the float64 dense solve's in "
              f"each of {KS_SOLVER_REPS} runs")

    est2 = tracker.trajectory()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "poses.txt")
        save_kitti_poses(path, est2)
        back = load_kitti_poses(path)
    ate_mem = float(ate_rmse(centers_from_poses(est2),
                             centers_from_poses(gt[:len(est2)])))
    ate_file = float(ate_rmse(centers_from_poses(back),
                              centers_from_poses(gt[:len(back)])))
    print(f"full_sequence pose file: {len(back)} poses, ATE {ate_file:.9f} "
          f"against {ate_mem:.9f} in memory")

    b = KS_KEYFRAMES
    check(hooks.ok >= KS_OK, f"full_sequence tracking-ok share >= {KS_OK}")
    check(b[0] <= n_kf <= b[1] and n_kf > KS_MF_CAMERAS,
          f"full_sequence keyframes within {b} and above {KS_MF_CAMERAS}")
    check(out["loop_closures"] >= KS_LOOPS,
          f"full_sequence closes >= {KS_LOOPS} loop")
    check(res.n_cameras > KS_MF_CAMERAS and res.cost < res.initial_cost,
          "global BA (schur_mf) lowers the cost")
    check(ate_gba <= KS_ATE_GBA and ate_gba <= KS_ATE_VS_TRACKED * ate_track,
          f"ATE after global BA <= {KS_ATE_GBA} and <= {KS_ATE_VS_TRACKED} "
          "x the tracked ATE")
    check(syncs == 0, "run_ba syncs the host only to read its result")
    check(abs(ate_file - ate_mem) <= KS_POSE_FILE_TOL * max(1.0, ate_mem),
          "the pose file gives the same ATE")
    print(f"full_sequence phase wall time: "
          f"{time.perf_counter() - t_phase:.1f} s")
    return {n: hooks.counts[n] for n in FRONTEND_PATH}, tracker


# the parallel phase: the port's in-process mesh (parallel/), on a
# 4-shard virtual mesh of the one card, and on cuda:0..3 as well where
# four cards are visible
PAR_SHARDS = 4
PAR_FRAMES = (8, 24)        # the data-parallel frontend: 4 frames a shard
PAR_MF_INIT_RTOL = 1e-5     # C = 1024 schur_mf: initial costs
PAR_MF_RTOL = 1e-2          # final cost vs the same solver on one shard
# final cost vs the one-device run_ba schur_mf: its block-Jacobi CG and the
# sharded solver's scalar-Jacobi CG stop at 24 iterations in different
# places; the JAX package's own pair parts by 10.0% on this problem
# (CPU: 6.5644e-05 sharded vs 5.9676e-05 one device)
PAR_MF_SINGLE_RTOL = 0.15
PAR_WIN_TOL = dict(R=5e-4, t=5e-3, X=2e-2, init=1e-5, drop=1e-3)
# global BA against the one-device solve (another CG): costs, as
# tests/test_global_ba.py (monocular scale gauge); against the same
# sharded solver on 1 shard: final costs and aligned centres
PAR_GBA_RTOL = 0.2
PAR_GBA_SHARD_RTOL = 1e-2
PAR_GBA_CENTRES = 0.03
PAR_SEQ_FRAMES = 56         # Tracker(mesh) over frames 0..55 (SEQ_BOUNDS)
# Tracker(mesh), once per RANSAC seed 0..7: its ATE's median and maximum
# over the seeds, bounded at twice the JAX package's Tracker on the same
# features with the same synchronous window BA over the same seeds
# (tests/jax_sequence_bounds.py --sync --seeds 8, on the sequence phase's
# features: ATE median 0.4546, max 0.8361; 0.2652 at seed 0, 0.5861 at
# seeds 1, 5 and 7, 0.8361 at seed 2). On these frames the ATE depends on
# the inlier set the two-view init's RANSAC draws, in both packages
# (PERF.md, Findings)
PAR_SEQ_SEEDS = 8
PAR_SEQ_BOUNDS = dict(ate_median=0.9091, ate_max=1.6722)
# seed 0: Tracker(mesh) vs the one-device tracker with the same
# (synchronous) window BA: 3 runs each of both on the H100 parted by
# 0.14% in ATE and 0% in keyframes (PERF.md, Findings)
PAR_SEQ_ATE = 0.05
PAR_SEQ_INLIERS = 0.02
PAR_PIPE_FRAMES = 24
PAR_PIPE_BATCH = 8


def window_problem(dev, C: int = 10, C_pad: int = 12, L: int = 2048,
                   per: int = 3, seed: int = 5):
    """A FAST_CONFIG window-sized BA problem (numpy only): C = 10 cameras on
    a slow dolly, padded to 12 with invalid identity cameras (as the
    tracker pads a window for a 4-shard mesh), L = 2048 landmarks each
    seen by 3 consecutive cameras (O = 6144), noise-free measurements,
    poses and points perturbed; the first camera is the gauge."""
    from visualslam_tpu_torch.backend.ba import BAProblem
    from visualslam_tpu_torch.geometry import se3

    r = np.random.default_rng(seed)
    a = 0.01 * np.arange(C)
    R = np.stack([[[np.cos(x), 0, np.sin(x)], [0, 1, 0],
                   [-np.sin(x), 0, np.cos(x)]] for x in a])
    cw = np.stack([0.05 * np.arange(C), np.zeros(C), 0.4 * np.arange(C)], -1)
    t = -np.einsum("cij,cj->ci", R, cw)
    X = np.stack([r.uniform(-15, 15, L), r.uniform(-6, 6, L),
                  r.uniform(10, 40, L)], -1)
    cam_idx = (r.integers(0, C - per + 1, L)[:, None]
               + np.arange(per)).reshape(-1)
    lm_idx = np.repeat(np.arange(L), per)
    Xc = np.einsum("oij,oj->oi", R[cam_idx], X[lm_idx]) + t[cam_idx]
    uv = Xc[:, :2] / Xc[:, 2:]
    xi = r.normal(0, 0.01, (C, 6))
    xi[0] = 0
    dR, dt = (v.double().numpy() for v in se3.se3_exp(
        torch.tensor(xi, dtype=torch.float32)))
    R0 = np.concatenate([dR @ R, np.tile(np.eye(3), (C_pad - C, 1, 1))])
    t0 = np.concatenate([np.einsum("cij,cj->ci", dR, t) + dt,
                         np.zeros((C_pad - C, 3))])

    def T(x, dtype=torch.float32):
        return torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)

    return BAProblem(
        R=T(R0), t=T(t0), X=T(X + r.normal(0, 0.05, X.shape)),
        cam_idx=T(cam_idx, torch.int32), lm_idx=T(lm_idx, torch.int32),
        uv=T(uv), obs_valid=T(np.ones(len(cam_idx), bool), torch.bool),
        cam_valid=T(np.arange(C_pad) < C, torch.bool),
        lm_valid=T(np.ones(L, bool), torch.bool))


def par_frontend(mesh, frontend: SiftFrontend, frames_dev: torch.Tensor,
                 name: str) -> dict:
    """The data-parallel frontend at full width (FAST_CONFIG, frames
    8..23, 4 a shard), launch counts reset just before it and read just
    after; each shard's features against the one-device frontend on the
    same 4-frame chunk (the banded blur's reduction order depends on the
    batch width), the psum'd total against the one-device sum."""
    from visualslam_tpu_torch.parallel.dryrun import data_parallel_frontend
    from visualslam_tpu_torch.parallel.mesh import make_mesh

    dmesh = make_mesh(mesh.size, "data", mesh.devices)
    batch = frames_dev[PAR_FRAMES[0]:PAR_FRAMES[1]]
    data_parallel_frontend(frontend, batch, dmesh)       # warm every device
    torch.cuda.synchronize()
    reset_launch_counts()
    t0 = time.perf_counter()
    feats, total = data_parallel_frontend(frontend, batch, dmesh)
    for d in set(mesh.devices):
        torch.cuda.synchronize(d)
    ms = 1e3 * (time.perf_counter() - t0)
    counts = launch_counts()
    per = batch.shape[0] // mesh.size
    worst, n_one = {}, 0
    for s, f in enumerate(feats):
        one = frontend(batch[s * per:(s + 1) * per])
        n_one += int(one.keypoints.valid.sum())
        check(torch.equal(f.keypoints.valid.cpu(), one.keypoints.valid.cpu()),
              f"{name} shard {s}: the same keypoints as the one-device "
              "frontend")
        for field, a, b in (("yx", f.keypoints.yx, one.keypoints.yx),
                            ("orientation", f.keypoints.orientation,
                             one.keypoints.orientation),
                            ("descriptors", f.descriptors, one.descriptors)):
            err = float((a.to(b.device) - b).abs().max())
            worst[field] = max(worst.get(field, 0.0), err)
    totals = [int(v) for v in total]
    print(f"parallel {name} data-parallel frontend: {batch.shape[0]} frames "
          f"of {H}x{W} over {mesh.size} shards, {ms:.3f} ms (host clock + "
          f"synchronize, {1e3 * batch.shape[0] / ms:.1f} frames/s); "
          f"launches {({n: counts[n] for n in FRONTEND_PATH})}; psum'd "
          f"detections {totals} vs one-device {n_one}; max |shard - "
          f"one-device| {json.dumps(worst)}")
    for n in FRONTEND_PATH:
        check(counts[n] == 3 * mesh.size, f"{name}: {n} launched once per "
              "octave on every shard")
    check(all(v == n_one for v in totals), f"{name}: the psum'd detection "
          "count equals the one-device sum on every shard")
    check(all(v == 0.0 for v in worst.values()), f"{name}: each shard's "
          "features equal the one-device frontend's bit for bit")
    return {n: counts[n] for n in FRONTEND_PATH}


def par_traj_mf(mesh, dev, name: str) -> None:
    """The dry run's sequence-scale problem (C = 1024, L = 4096, 16k
    observations; 2 LM iterations of 24 CG steps) through the matrix-free
    trajectory-sharded solver, against the same solver on a 1-shard mesh
    and against the one-device run_ba schur_mf."""
    from visualslam_tpu_torch.parallel.dryrun import (
        TRAJ_MF_CONFIG,
        traj_mf_problem,
    )
    from visualslam_tpu_torch.parallel.mesh import make_mesh
    from visualslam_tpu_torch.parallel.traj_ba import (
        run_ba_traj_sharded,
        shard_problem_trajectory,
    )

    p = traj_mf_problem(dev)
    cfg = TRAJ_MF_CONFIG
    sp = shard_problem_trajectory(p, mesh.size)
    sp1 = shard_problem_trajectory(p, 1)
    one = make_mesh(1, devices=[dev])
    sharded = run_ba_traj_sharded(sp, cfg, mesh)
    shard1 = run_ba_traj_sharded(sp1, cfg, one)
    single = run_ba(p, cfg)
    c = {k: (float(r.initial_cost), float(r.cost)) for k, r in
         (("sharded", sharded), ("one_shard", shard1), ("run_ba", single))}
    syncs = count_syncs(lambda: run_ba_traj_sharded(sp, cfg, mesh))
    ms_sh = wall_ms(lambda: float(run_ba_traj_sharded(sp, cfg, mesh).cost), 3)
    ms_one = wall_ms(lambda: float(run_ba_traj_sharded(sp1, cfg, one).cost),
                     3)
    ms_single = wall_ms(lambda: float(run_ba(p, cfg).cost), 3)
    launches, busy, _ = profile_call(
        lambda: run_ba_traj_sharded(sp, cfg, mesh))
    rel1 = abs(c["sharded"][1] - c["one_shard"][1]) / c["one_shard"][1]
    rels = abs(c["sharded"][1] - c["run_ba"][1]) / c["run_ba"][1]
    print(f"parallel {name} traj-sharded schur_mf C = {p.R.shape[0]}, L = "
          f"{p.X.shape[0]}, O = {int(p.obs_valid.sum())} valid of "
          f"{p.uv.shape[0]}, iters {cfg.iters}, cg {cfg.cg_iters}: (initial, "
          f"final) cost {json.dumps(c)}; final vs 1 shard {rel1:.3e}, vs "
          f"run_ba {rels:.3e}; ms per solve (host clock + read-back, median "
          f"of 3): {mesh.size} shards {ms_sh:.3f}, 1 shard {ms_one:.3f}, "
          f"run_ba {ms_single:.3f}; {syncs} host syncs inside the sharded "
          f"solve; {launches} device launches, device busy {busy} ms")
    for k in ("one_shard", "run_ba"):
        check(abs(c["sharded"][0] - c[k][0]) <= PAR_MF_INIT_RTOL * c[k][0],
              f"{name}: C = 1024 initial cost within {PAR_MF_INIT_RTOL} of "
              f"{k}")
    check(c["sharded"][1] < c["sharded"][0], f"{name}: C = 1024 sharded "
          "solve lowers the cost")
    check(rel1 <= PAR_MF_RTOL, f"{name}: C = 1024 final cost within "
          f"{PAR_MF_RTOL} of the same solver on one shard")
    check(rels <= PAR_MF_SINGLE_RTOL, f"{name}: C = 1024 final cost within "
          f"{PAR_MF_SINGLE_RTOL} of the one-device run_ba schur_mf")
    check(syncs == 0, f"{name}: no host sync inside the sharded C = 1024 "
          "solve")


def par_window(mesh, dev, name: str) -> None:
    """Window-size sharded BA (FAST_CONFIG.ba on window_problem: C = 10 of
    12, L = 2048, O = 6144): run_ba_sharded under psum and ring and the
    dense run_ba_traj_sharded, each against the one-device run_ba with
    tests/test_dist_ba.py's tolerances."""
    from visualslam_tpu_torch.parallel.dist_ba import (
        run_ba_sharded,
        shard_problem,
        unshard_points,
    )
    from visualslam_tpu_torch.parallel.traj_ba import (
        run_ba_traj_sharded,
        shard_problem_trajectory,
        unshard_traj,
    )

    p = window_problem(dev)
    cfg = FAST_CONFIG.ba.replace(max_cameras=int(p.R.shape[0]))
    single = run_ba(p, cfg)
    R1, t1, X1 = (v.cpu().numpy() for v in (single.R, single.t, single.X))
    sp = shard_problem(p, mesh.size)
    tp = shard_problem_trajectory(p, mesh.size)
    L = p.X.shape[0]
    runs = {
        "landmark psum": lambda: run_ba_sharded(sp, cfg, mesh, reduce="psum"),
        "landmark ring": lambda: run_ba_sharded(sp, cfg, mesh, reduce="ring"),
        "trajectory dense": lambda: run_ba_traj_sharded(tp, cfg, mesh),
    }
    tol = PAR_WIN_TOL
    out = {"run_ba": dict(cost=[float(single.initial_cost),
                                float(single.cost)],
                          ms=wall_ms(lambda: float(run_ba(p, cfg).cost), 3))}
    for k, fn in runs.items():
        r = fn()
        if k.startswith("landmark"):
            R, t = r.R.cpu().numpy(), r.t.cpu().numpy()
            X = unshard_points(r.X, sp.lm_order).cpu().numpy()
        else:
            R, t, X = unshard_traj(r.R, r.t, r.X, tp.lm_order, L)
        err = dict(R=float(np.abs(R - R1).max()),
                   t=float(np.abs(t - t1).max()),
                   X=float(np.abs(X - X1).max()))
        out[k] = dict(cost=[float(r.initial_cost), float(r.cost)], err=err,
                      ms=wall_ms(lambda: float(fn().cost), 3))
        c0 = float(r.initial_cost)
        check(abs(c0 - float(single.initial_cost))
              <= tol["init"] * float(single.initial_cost),
              f"{name} {k}: initial cost within {tol['init']}")
        check(float(r.cost) < tol["drop"] * c0, f"{name} {k}: cost below "
              f"{tol['drop']} of the initial")
        for f in ("R", "t", "X"):
            check(err[f] <= tol[f], f"{name} {k}: |{f} - one-device| <= "
                  f"{tol[f]}")
    print(f"parallel {name} window BA (C = 10 of {p.R.shape[0]}, L = {L}, O "
          f"= {p.uv.shape[0]}, FAST_CONFIG.ba): {json.dumps(out)} (ms per "
          f"solve, host clock + read-back, median of 3)")


def par_tracker(mesh, frames: np.ndarray, seq, dev, name: str) -> None:
    """Tracker(FAST_CONFIG, mesh=mesh) over frames 0..55 through bench's
    protocol (process_batch of 0..7, process_stream in batches of 16,
    finish), once for each RANSAC seed 0..PAR_SEQ_SEEDS-1: two-view init's
    window BA runs trajectory-sharded and, as in the reference, lands at
    once. Every run is held to SEQ_BOUNDS' tracking-ok share, keyframes
    and inliers; the ATE's median and maximum over the seeds to
    PAR_SEQ_BOUNDS, twice the JAX package's over the same seeds with the
    same (synchronous) window BA. Seed 0's run is also held to the
    one-device tracker with that timing (async_ba=False): keyframes equal,
    ATE and mean inliers within PAR_SEQ_ATE / PAR_SEQ_INLIERS."""
    from visualslam_tpu_torch.parallel import traj_ba

    calls = []
    run = traj_ba.run_ba_traj_sharded

    def counted(*a, **kw):
        calls.append(1)
        return run(*a, **kw)

    def stream(tracker):
        t0 = time.perf_counter()
        tracker.process_batch(frames[:bench.INIT_FRAMES], 0)
        for k in range(bench.INIT_FRAMES, PAR_SEQ_FRAMES, BATCH):
            tracker.process_stream(frames[k:min(k + BATCH, PAR_SEQ_FRAMES)],
                                   k)
        tracker.finish()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    gt = seq.gt_poses[:, :, 3]
    runs = []
    for seed in range(PAR_SEQ_SEEDS):
        cfg = FAST_CONFIG.replace(
            ransac=FAST_CONFIG.ransac.replace(seed=seed))
        calls.clear()
        traj_ba.run_ba_traj_sharded = counted
        try:
            tracker = Tracker(cfg, seq.intrinsics, device=dev, mesh=mesh)
            wall = stream(tracker)
        finally:
            traj_ba.run_ba_traj_sharded = run
        stats = sequence_stats(tracker, gt, PAR_SEQ_FRAMES)
        runs.append(dict(seed=seed, s=round(wall, 3), sharded=len(calls),
                         last_cost=tracker.last_ba_cost, **stats))
        check(len(calls) > 0 and tracker.last_ba_cost >= 0,
              f"{name} seed {seed}: the tracker's window BA ran sharded")
        check(len(tracker.frames) == PAR_SEQ_FRAMES, f"{name} seed {seed}: "
              "every frame committed")
        b = SEQ_BOUNDS
        check(stats["ok"] >= b["ok"], f"{name} seed {seed}: tracking-ok "
              "share")
        check(b["keyframes"][0] <= stats["keyframes"] <= b["keyframes"][1],
              f"{name} seed {seed}: keyframes within {b['keyframes']}")
        check(b["mean_inliers"][0] <= stats["mean_inliers"]
              <= b["mean_inliers"][1],
              f"{name} seed {seed}: mean inliers within "
              f"{b['mean_inliers']}")
    sync_cfg = FAST_CONFIG.replace(ba=FAST_CONFIG.ba.replace(async_ba=False))
    one = Tracker(sync_cfg, seq.intrinsics, device=dev)
    wall_one = stream(one)
    ref = sequence_stats(one, gt, PAR_SEQ_FRAMES)
    ate = [r["ate"] for r in runs]
    fig = dict(ate_median=float(np.median(ate)), ate_max=max(ate))
    print(f"parallel {name} Tracker(FAST_CONFIG, mesh): frames 0.."
          f"{PAR_SEQ_FRAMES - 1}, RANSAC seeds 0..{PAR_SEQ_SEEDS - 1}: "
          f"{json.dumps(runs)}; {json.dumps(fig)} (bounds "
          f"{json.dumps(PAR_SEQ_BOUNDS)}; SEQ_BOUNDS {json.dumps(SEQ_BOUNDS)}"
          f"); seed 0 on one device, async_ba=False, in {wall_one:.3f} s: "
          f"{json.dumps(ref)}, last cost {one.last_ba_cost:.6e}")
    for k, v in fig.items():
        check(v <= PAR_SEQ_BOUNDS[k], f"{name} tracker: ATE {k} over the "
              f"seeds <= {PAR_SEQ_BOUNDS[k]} (twice the JAX package's)")
    r0 = runs[0]
    check(r0["keyframes"] == ref["keyframes"], f"{name}: the mesh and the "
          "one-device tracker promote the same number of keyframes")
    check(abs(r0["ate"] - ref["ate"]) <= PAR_SEQ_ATE * ref["ate"],
          f"{name}: ATE within {PAR_SEQ_ATE} of the one-device tracker's")
    check(abs(r0["mean_inliers"] - ref["mean_inliers"])
          <= PAR_SEQ_INLIERS * ref["mean_inliers"],
          f"{name}: mean inliers within {PAR_SEQ_INLIERS} of the "
          "one-device tracker's")


def par_global_ba(mesh, ks_tracker, dev, name: str) -> None:
    """global_ba(mesh=mesh) on full_sequence's KITTI-scale tracker (C = 67
    keyframes padded to a multiple of the shards, schur_mf) against the
    same trajectory-sharded solver on a 1-shard mesh (the same algorithm:
    final costs within PAR_GBA_SHARD_RTOL, Sim(3)-aligned camera centres
    within PAR_GBA_CENTRES) and against the one-device run_global_ba
    (block- where the sharded CG is scalar-Jacobi: costs within
    PAR_GBA_RTOL), all of the same map: global BA reads the map and writes
    only the frame results, so no run sees another's write-back. The
    trajectory the sharded solve leaves is no worse against ground truth
    than KS_ATE_VS_TRACKED x the one-device global BA's, which the frames
    carry on entry."""
    from visualslam_tpu_torch.parallel.mesh import make_mesh
    from visualslam_tpu_torch.slam.evaluation import (
        ate_rmse,
        centers_from_poses,
    )
    from visualslam_tpu_torch.slam.global_ba import run_global_ba

    gt = centers_from_poses(SyntheticSequence(
        num_frames=KS_FRAMES, trajectory="loop", **KS_WORLD).gt_poses)
    ate_one = float(ate_rmse(centers_from_poses(ks_tracker.trajectory()),
                             gt))
    lc = ks_tracker.loop_closer
    corrected = None if lc is None or lc.corrected is None else {
        int(e.frame_id): (np.asarray(R), np.asarray(t))
        for e, (R, t) in zip(lc.entries, lc.corrected)}
    # the tracker's global_ba first: it lands any pending window BA in the
    # map before the other solves read it
    t0 = time.perf_counter()
    sh = ks_tracker.global_ba(mesh=mesh)
    s_sh = time.perf_counter() - t0
    ate_sh = float(ate_rmse(centers_from_poses(ks_tracker.trajectory()), gt))
    t0 = time.perf_counter()
    sh1 = run_global_ba(ks_tracker.map, ks_tracker.cfg.ba, corrected,
                        mesh=make_mesh(1, devices=[dev]), device=dev)
    s_sh1 = time.perf_counter() - t0
    t0 = time.perf_counter()
    one = run_global_ba(ks_tracker.map, ks_tracker.cfg.ba, corrected,
                        device=dev)
    s_one = time.perf_counter() - t0

    def centres(r):
        return np.stack([-R.T @ t for R, t in zip(r.R, r.t)])

    path = float(np.linalg.norm(np.diff(centres(sh1), axis=0),
                                axis=1).sum())
    apart1 = float(ate_rmse(centres(sh), centres(sh1)))
    apart = float(ate_rmse(centres(sh), centres(one)))
    rel1 = abs(sh.cost - sh1.cost) / sh1.cost
    rel = abs(sh.cost - one.cost) / one.cost
    print(f"parallel {name} global BA: {sh.n_cameras} cameras (padded to a "
          f"multiple of {mesh.size}), {sh.n_landmarks} landmarks, "
          f"{sh.n_observations} observations; cost (initial -> final, "
          f"seconds for build + solve + read-back): {mesh.size} shards "
          f"{sh.initial_cost:.6e} -> {sh.cost:.6e} in {s_sh:.3f} s, 1 shard "
          f"{sh1.initial_cost:.6e} -> {sh1.cost:.6e} in {s_sh1:.3f} s, one "
          f"device {one.initial_cost:.6e} -> {one.cost:.6e} in {s_one:.3f} "
          f"s; final costs {rel1:.3e} from 1 shard, {rel:.3e} from one "
          f"device; Sim(3)-aligned centres {apart1:.6f} from 1 shard, "
          f"{apart:.6f} from one device, over a {path:.3f} keyframe path; "
          f"ATE against ground truth {ate_sh:.4f} after the sharded solve, "
          f"{ate_one:.4f} after the one-device one")
    check(sh.n_cameras == sh1.n_cameras == one.n_cameras
          and sh.cost < sh.initial_cost,
          f"{name}: sharded global BA lowers the cost")
    check(rel1 <= PAR_GBA_SHARD_RTOL, f"{name}: global BA final cost within "
          f"{PAR_GBA_SHARD_RTOL} of the same solver on 1 shard")
    check(apart1 < PAR_GBA_CENTRES, f"{name}: global BA Sim(3)-aligned "
          f"centres within {PAR_GBA_CENTRES} of the same solver on 1 shard")
    check(rel <= PAR_GBA_RTOL, f"{name}: global BA costs within "
          f"{PAR_GBA_RTOL} of the one-device solve")
    check(ate_sh <= KS_ATE_VS_TRACKED * ate_one,
          f"{name}: ATE after the sharded global BA <= {KS_ATE_VS_TRACKED} "
          "x the one-device global BA's")


def par_pipeline(frames: np.ndarray, seq, dev, name: str) -> None:
    """pipelined_process over frames 0..23 in batches of 8 against chunked
    detect_batch + process_features on a second tracker, in the default
    mode: the trajectories equal bit for bit; frames/s of both (host
    clock)."""
    from visualslam_tpu_torch.parallel.pipeline import pipelined_process

    imgs = frames[:PAR_PIPE_FRAMES]
    B = PAR_PIPE_BATCH
    fps = {}
    for _ in range(2):            # the first turn warms both loops up
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq_t = Tracker(FAST_CONFIG, seq.intrinsics, device=dev)
        for k in range(0, len(imgs), B):
            fb = seq_t.detect_batch(imgs[k:k + B])
            for i in range(len(imgs[k:k + B])):
                seq_t.process_features(Tracker.features_at(fb, i), k + i)
        torch.cuda.synchronize()
        fps["sequential"] = len(imgs) / (time.perf_counter() - t0)
        t0 = time.perf_counter()
        pipe_t = Tracker(FAST_CONFIG, seq.intrinsics, device=dev)
        res = pipelined_process(pipe_t, imgs, batch=B)
        torch.cuda.synchronize()
        fps["pipelined"] = len(imgs) / (time.perf_counter() - t0)
    same = np.array_equal(seq_t.trajectory(), pipe_t.trajectory())
    print(f"parallel {name} pipeline: frames 0..{len(imgs) - 1} at {H}x{W} "
          f"in batches of {B} (host path, default mode): "
          f"frames/s {json.dumps(fps)}; trajectories equal bit for bit: "
          f"{same}; keyframes "
          f"{sum(f.is_keyframe for f in pipe_t.frames)}")
    check([r.frame_id for r in res] == list(range(len(imgs))),
          f"{name}: the pipeline returns every frame in order")
    check(same, f"{name}: pipelined and sequential trajectories equal bit "
          "for bit")


def phase_parallel(frames: np.ndarray, frontend: SiftFrontend, card: str,
                   dev, ks_tracker) -> dict:
    """The parallel paths over a 4-shard virtual mesh of the one card (and
    over cuda:0..3 where four cards are visible): the dry run, the
    data-parallel frontend at full width, the C = 1024 matrix-free
    trajectory-sharded BA, window-size sharded BA (landmark psum / ring,
    trajectory dense), Tracker(mesh) over frames 0..55, global BA over the
    mesh on the KITTI-scale tracker, and the stage-overlapped pipeline.
    Returns the frontend kernels' launches on the data-parallel path."""
    from visualslam_tpu_torch.parallel.dryrun import run_dryrun
    from visualslam_tpu_torch.parallel.mesh import make_mesh

    t_phase = time.perf_counter()
    print(f"parallel: {card}")
    # bench's world, frames 0..55 (frame k depends on k alone)
    seq = SyntheticSequence(num_frames=PAR_SEQ_FRAMES, h=H, w=W, n_dots=8000,
                            step=0.4)
    extra = [seq.frame(k) for k in range(len(frames), PAR_SEQ_FRAMES)]
    if extra:
        extra = np.clip(np.stack(extra) * 255.0, 0, 255).astype(np.uint8)
        frames = np.concatenate([frames, extra])
    frames_dev = torch.from_numpy(frames[:PAR_FRAMES[1]]).to(dev)
    meshes = [("virtual", make_mesh(PAR_SHARDS, devices=[dev] * PAR_SHARDS))]
    if torch.cuda.device_count() >= PAR_SHARDS:
        meshes.append(("cards", make_mesh(PAR_SHARDS)))
    names = [(n, [str(d) for d in m.devices]) for n, m in meshes]
    print(f"parallel meshes: {names} (a virtual mesh runs its shards one "
          f"after another on one card: its times are no multi-GPU scaling "
          f"figure)")
    counts = dict.fromkeys(FRONTEND_PATH, 0)
    for name, mesh in meshes:
        run_dryrun(PAR_SHARDS, devices=list(mesh.devices))
        for k, v in par_frontend(mesh, frontend, frames_dev, name).items():
            counts[k] += v
        par_traj_mf(mesh, dev, name)
        par_window(mesh, dev, name)
        par_tracker(mesh, frames, seq, dev, name)
        par_global_ba(mesh, ks_tracker, dev, name)
    par_pipeline(frames, seq, dev, "virtual")
    print(f"parallel phase wall time: {time.perf_counter() - t_phase:.1f} s")
    return counts


def main() -> None:
    args = sys.argv[1:]
    save = args[args.index("--save-features") + 1] \
        if "--save-features" in args else None
    save_seq = args[args.index("--save-sequence-features") + 1] \
        if "--save-sequence-features" in args else None
    save_ref = args[args.index("--save-reference-features") + 1] \
        if "--save-reference-features" in args else None
    save_orb = args[args.index("--save-orb-features") + 1] \
        if "--save-orb-features" in args else None
    dev, card = phase_device()
    phase_build()
    if "--segment-turns" in args:
        segment_turns(args[args.index("--segment-turns") + 1], dev)
        return
    frames, seq = render_frames()
    frames_dev = torch.from_numpy(frames).to(dev)
    frontend = SiftFrontend(FAST_CONFIG).to(dev)
    if "--solver-turns" in args:
        solver_turns(args[args.index("--solver-turns") + 1], dev,
                     frames_dev, frontend, seq)
        return
    plain = SiftFrontend(FAST_CONFIG, PLAIN).to(dev)
    # warm both paths (allocator, band buffers, cuBLAS handles)
    frontend(frames_dev[:BATCH])
    plain(frames_dev[:BATCH])
    timings = phase_kernels(frames_dev[8:8 + BATCH], frontend, seq, dev,
                            frames_dev)
    phase_slice(frames_dev, frontend, plain)
    track = phase_track(frames_dev, seq, frontend, card, dev)
    engine_counts = phase_engine(frames_dev, seq, card, dev, save)
    del plain
    sequence_counts = phase_sequence(card, dev, save_seq)
    phase_harris_5pt(frames_dev, frontend, seq, card, dev)
    reference_counts = phase_reference(frames_dev, card, dev, save_ref)
    phase_orb(frames_dev, card, dev, save_orb)
    harness_counts = phase_harness(card)
    del frames_dev
    _, ks_tracker = phase_full_sequence(card, dev)
    parallel_counts = phase_parallel(frames, frontend, card, dev, ks_tracker)
    del ks_tracker
    # each kernel's launches on the paths that run it: the main path (the
    # sequence), the reference sequence, the harness's SIFT row and the
    # data-parallel frontend for the three frontend kernels, the engine
    # path for the three opt-in ones, the main path for segment_sum
    launches = dict(engine_counts, **{
        n: sequence_counts[n] + reference_counts[n] + harness_counts[n]
        + parallel_counts[n] for n in FRONTEND_PATH})
    for name in ("segment_sum", "sym_eigh", "svd3"):
        launches[name] = sequence_counts[name]
    check(all(launches[name] > 0 for name in SOURCES),
          "every kernel launched on the sequence or the engine path")
    check(track["extrema_winners"] > 0, "extrema_winners on the track path")
    print(f"device: {card}")
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": r["err"], "ms": r["ms"],
         "kernel_ms": r["kernel_ms"], "plain_ms": r["plain_ms"],
         "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
         "library_ms": r["library_ms"]}
        for name, r in timings.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

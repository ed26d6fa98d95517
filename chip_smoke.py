"""Drive the PyTorch + CUDA port's frontend slice once on an NVIDIA GPU.

    python3 chip_smoke.py        # from the repository root, one CUDA device

The slice is the first half of the benchmark's main path at its own shapes:
a batch of 16 uint8 frames of 376x1248 from the synthetic sequence through
the batched SIFT frontend (FAST_CONFIG, 3 octaves), then each consecutive
pair of frames matched. Phases, each printing its own lines:

  1. device    the card's name and power limit, CUDA version; TF32 off
  2. build     nvcc-compiles the kernels from csrc/ (timed, with the
               compiler's register / spill report)
  3. kernels   each kernel against its plain version on the card at the
               octave-0 shapes: the extrema winners and the candidates
               that follow bit for bit, the orientation histogram and the
               descriptor within 1e-4 * (1 + max |plain|); median times
  4. slice     the frontend + matching through the public entry points,
               with the launch counters reset just before and read just
               after; the plain path on the same batch as the reference;
               keypoint and match floors; frames/s of both paths
  5. result    one JSON line of per-kernel numbers, then the last line
               {"ok": true, "device": {...}}

Any failed check raises, so the run exits non-zero and prints no result.
Without a CUDA device it exits non-zero before doing anything.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

from visualslam_tpu_torch.frontend import SiftFrontend
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.models.matching import match_features
from visualslam_tpu_torch.models.pyramid import build_pyramid
from visualslam_tpu_torch.models.types import Features, Keypoints
from visualslam_tpu_torch.ops.cuda import (
    KERNELS,
    PLAIN,
    build,
    launch_counts,
    reset_launch_counts,
)
from visualslam_tpu_torch.ops.extrema import detect_extrema, extrema_candidates
from visualslam_tpu_torch.ops.histograms import histogram_peaks
from visualslam_tpu_torch.ops.patches import crop_patches
from visualslam_tpu_torch.utils.config import FAST_CONFIG

H, W, BATCH = 376, 1248, 16
KERNEL_TOL = 1e-4           # x (1 + max |plain|): summation order only
MIN_KEYPOINTS = 800         # per frame
MIN_MATCHES = 250           # per consecutive pair
SOURCES = {
    "extrema_winners": ("visualslam_tpu_torch/csrc/extrema.cu",
                        "visualslam_tpu/ops/pallas/extrema.py:256"),
    "orient_hist": ("visualslam_tpu_torch/csrc/descriptor.cu",
                    "visualslam_tpu/ops/pallas/descriptor.py:180"),
    "descriptor": ("visualslam_tpu_torch/csrc/descriptor.cu",
                   "visualslam_tpu/ops/pallas/descriptor.py:212"),
}


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


def frame_pairs(f: Features):
    """(frames 0..B-2, frames 1..B-1) of a batched Features."""
    return (Features(Keypoints(*(t[:-1] for t in f.keypoints)),
                     f.descriptors[:-1]),
            Features(Keypoints(*(t[1:] for t in f.keypoints)),
                     f.descriptors[1:]))


def phase_device() -> torch.device:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device "
                         "(torch.cuda.is_available() is False)")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    print(f"device: {smi.stdout.strip().splitlines()[0]}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.device_count()} device(s), using "
          f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda:0")


def phase_build() -> None:
    t0 = time.perf_counter()
    for name in ("extrema", "descriptor"):
        build.load_library(name)
    print(f"build: {time.perf_counter() - t0:.1f} s (nvcc "
          f"{' '.join(build.NVCC_FLAGS[:2])})")
    for name in ("extrema", "descriptor"):
        for line in build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}.cu: {line.strip()}")


def render_frames() -> np.ndarray:
    """The benchmark's frames: 24 of the 376x1248 synthetic sequence, as
    uint8 (as bench.py ships them)."""
    t0 = time.perf_counter()
    seq = SyntheticSequence(num_frames=24, h=H, w=W, n_dots=8000, step=0.4)
    frames = np.stack([seq.frame(k) for k in range(len(seq))])
    frames = np.clip(frames * 255.0, 0, 255).astype(np.uint8)
    print(f"frames: {frames.shape} uint8 rendered in "
          f"{time.perf_counter() - t0:.1f} s")
    return frames


def phase_kernels(batch: torch.Tensor, frontend: SiftFrontend) -> dict:
    """Each kernel against its plain version at the octave-0 shapes."""
    cfg = FAST_CONFIG
    thr = cfg.sift.contrast_threshold
    cap = cfg.sift.octave_capacity(0)
    ss = build_pyramid(batch.float() * (1.0 / 255.0), cfg.pyramid,
                       frontend.bands)
    dog = ss.dog[0].contiguous()                         # [16, 5, 376, 1248]
    out = {}

    got = KERNELS.extrema_winners(dog, thr)
    want = PLAIN.extrema_winners(dog, thr)
    check(torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]),
          "extrema winners equal their plain version bit for bit")
    cand_k = extrema_candidates(dog, thr, cap, KERNELS)
    cand_p = extrema_candidates(dog, thr, cap, PLAIN)
    for i, name in ((0, "lvl"), (1, "y"), (2, "x"), (4, "sel")):
        check(torch.equal(cand_k[i], cand_p[i]),
              f"extrema candidates' {name} equal bit for bit")
    err = (got[0] - want[0]).abs().max().item()
    out["extrema_winners"] = (err, time_ms(
        lambda: KERNELS.extrema_winners(dog, thr), 20), time_ms(
        lambda: PLAIN.extrema_winners(dog, thr), 5))
    print(f"kernel extrema_winners: dog {tuple(dog.shape)}, winners and "
          f"{int(cand_k[4].sum())} candidates bit-exact")

    # the frontend's octave-0 patches: bf16, 32 rows, K = 16 * 1024
    lvl, y, x, offset, _, _ = detect_extrema(dog, cfg.sift, cap, KERNELS)
    mag_ori = torch.stack([ss.grad_mag[0], ss.grad_ori[0]], 1).to(
        torch.bfloat16)
    yx = torch.stack([y, x], -1).float()
    patches, y0, x0 = crop_patches(mag_ori, (lvl - 1).long(), yx, 32)
    patches, y0, x0 = patches.flatten(0, 1), y0.flatten(), x0.flatten()
    yx = yx.flatten(0, 1)
    lvl_f = (lvl.float() + offset[..., 0]).flatten()
    sigma = (cfg.sift.orientation_sigma_scale * cfg.pyramid.base_sigma
             * cfg.pyramid.k_factor ** lvl_f).contiguous()
    hist_p = PLAIN.orient_hist(patches, y0, x0, yx, sigma)
    angle = histogram_peaks(hist_p, 1, 0.8, 360.0)[0][:, 0].contiguous()
    yxf = (yx + offset[..., 1:3].flatten(0, 1)).contiguous()
    for name, args in (("orient_hist", (patches, y0, x0, yx, sigma)),
                       ("descriptor", (patches, y0, x0, yxf, angle))):
        kfn, pfn = getattr(KERNELS, name), getattr(PLAIN, name)
        got, want = kfn(*args), pfn(*args)
        check(bool(torch.isfinite(got).all()), f"{name} output is finite")
        err = (got - want).abs().max().item()
        bound = KERNEL_TOL * (1.0 + want.abs().max().item())
        print(f"kernel {name}: patches {tuple(patches.shape)} "
              f"{patches.dtype}, max |kernel - plain| = {err:.3e} "
              f"(bound {bound:.3e})")
        check(err <= bound, f"{name} within {KERNEL_TOL} x (1 + max|plain|)")
        out[name] = (err, time_ms(lambda: kfn(*args), 20),
                     time_ms(lambda: pfn(*args), 5))
    for name, (err, ms, plain_ms) in out.items():
        print(f"time {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
    return out


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
    for name, n in launches.items():
        check(n == cfg.pyramid.num_octaves,
              f"{name} launched once per octave on the main path")

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
    print(f"peak device memory: "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return launches


def main() -> None:
    dev = phase_device()
    phase_build()
    frames_dev = torch.from_numpy(render_frames()).to(dev)
    frontend = SiftFrontend(FAST_CONFIG).to(dev)
    plain = SiftFrontend(FAST_CONFIG, PLAIN).to(dev)
    # warm both paths (allocator, band buffers, cuBLAS handles)
    frontend(frames_dev[:BATCH])
    plain(frames_dev[:BATCH])
    timings = phase_kernels(frames_dev[8:8 + BATCH], frontend)
    launches = phase_slice(frames_dev, frontend, plain)
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": SOURCES[name][0],
         "replaces": SOURCES[name][1], "launches": launches[name],
         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms}
        for name, (err, ms, plain_ms) in timings.items()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())

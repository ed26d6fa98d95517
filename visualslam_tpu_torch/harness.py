"""Per-stage benchmark harness (the JAX package's benchmarks/harness.py):

    python -m visualslam_tpu_torch.cli benchmark [--device cpu] [--out PATH]

Times each stage on one device under DEFAULT_CONFIG at 376x1248, with the
JAX harness's rows, seeds, shapes and result keys:

  pyramid      build_pyramid on a KITTI-sized frame
  frontend     full SIFT detect+describe
  orb          full ORB detect+describe
  match        1024x1024 descriptor matching (L2 + ratio + mutual)
  ransac       512-hypothesis essential RANSAC on 512 matches
  ba           10-camera / 4k-landmark / 16k-observation LM iteration
  rotated      512 rotated 16x16 patches from a 512x512 image
  pnp          motion-only refinement, 512 points

Each call ends in a scalar read back to the host, which waits for the
device; a stage's figure is the median of 8 such calls after 2 warmup calls
(the warmups also build the CUDA kernels and warm the allocator). TF32 stays
off. The results go to `out` (HARNESS_TORCH.json at the repository root by
default) with the device: on the card its name and power limit.
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from visualslam_tpu_torch.utils.card import device_label, require_device

DEFAULT_OUT = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "HARNESS_TORCH.json")


def _time(fn, args_list, warmup=2, iters=8):
    """Median seconds of fn(*args) over `iters` calls after `warmup`
    calls, cycling through args_list; each call reads back a scalar."""
    for i in range(warmup):
        float(fn(*args_list[i % len(args_list)]))
    ts = []
    for i in range(iters):
        a = args_list[(i + warmup) % len(args_list)]
        t0 = time.perf_counter()
        float(fn(*a))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def scalar(tree) -> torch.Tensor:
    """Sum of every floating tensor in a nested tuple (the value the JAX
    harness reads back)."""
    if isinstance(tree, torch.Tensor):
        return tree.sum() if tree.is_floating_point() else 0.0
    return sum((scalar(x) for x in tree), torch.zeros(()))


def run_benchmarks(full: bool = False, h: int = 376, w: int = 1248,
                   device="cuda", out: str | None = None) -> dict:
    """The harness's rows on `device` (the card by default; without one it
    raises). Returns {row key: figure}; writes {"device", "image", rows}
    as JSON to `out`. `full` is accepted as the JAX harness accepts it."""
    from visualslam_tpu_torch.backend.pnp import refine_pose
    from visualslam_tpu_torch.frontend import make_frontend
    from visualslam_tpu_torch.geometry.ransac import (
        estimate_relative_pose,
        generator,
    )
    from visualslam_tpu_torch.models.matching import match_features
    from visualslam_tpu_torch.models.pyramid import build_pyramid
    from visualslam_tpu_torch.models.types import Features, Keypoints
    from visualslam_tpu_torch.ops.patches import extract_rotated_patches
    from visualslam_tpu_torch.utils.config import DEFAULT_CONFIG
    from visualslam_tpu_torch.utils.precision import f32_matmul

    dev = require_device(device, "run_benchmarks")
    f32_matmul()
    label = device_label(dev)
    cfg = DEFAULT_CONFIG
    rng = np.random.default_rng(0)
    imgs = [torch.from_numpy(rng.random((h, w), dtype=np.float32)).to(dev)
            for _ in range(4)]
    results: dict[str, float] = {}
    print(f"[bench] device={label} image={h}x{w}", file=sys.stderr)

    def t(v):
        return torch.as_tensor(v, device=dev)

    sift = make_frontend(cfg).to(dev)
    orb = make_frontend(cfg.replace(frontend="orb")).to(dev)
    with torch.no_grad():
        results["pyramid_ms"] = _time(
            lambda im: scalar(build_pyramid(im[None], cfg.pyramid,
                                            sift.bands, resize=sift.resize)),
            [(i,) for i in imgs]) * 1e3
        results["sift_frontend_ms"] = _time(
            lambda im: scalar(sift(im[None])), [(i,) for i in imgs]) * 1e3
        results["orb_frontend_ms"] = _time(
            lambda im: scalar(orb(im[None])), [(i,) for i in imgs]) * 1e3

        # matching (1024 x 1024, 128-D)
        def feats(seed):
            d = np.random.default_rng(seed).standard_normal((1024, 128))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            kps = Keypoints.empty(1024, dev)._replace(
                valid=torch.ones(1024, dtype=torch.bool, device=dev))
            return Features(kps, t(d.astype(np.float32)))

        fs = [feats(i) for i in range(4)]
        results["match_ms"] = _time(
            lambda a, b: scalar(match_features(a, b, cfg.match)),
            [(fs[i], fs[(i + 1) % 4]) for i in range(4)]) * 1e3

        # RANSAC (512 matches, 512 hypotheses)
        def ransac_args(seed):
            r = np.random.default_rng(seed)
            X = r.uniform([-2, -2, 4], [2, 2, 10], (512, 3))
            x1 = X[:, :2] / X[:, 2:]
            X2 = X + np.array([0.3, 0, 0])
            x2 = X2[:, :2] / X2[:, 2:]
            return (t(x1.astype(np.float32)), t(x2.astype(np.float32)),
                    torch.ones(512, dtype=torch.bool, device=dev), seed)

        results["ransac_ms"] = _time(
            lambda x1, x2, v, s: scalar(estimate_relative_pose(
                x1, x2, v, cfg.ransac, generator(s, dev))[:3]),
            [ransac_args(i) for i in range(4)]) * 1e3

        # BA: 10 cams, 4096 landmarks, 16384 obs, one LM iteration
        results.update(_bench_ba(dev, _time))

        # rotated-window sampling (the reference's one micro-benchmark)
        def rot_args(seed):
            r = np.random.default_rng(seed)
            img = t(r.random((512, 512), dtype=np.float32))
            yx = t(r.uniform(20, 490, (512, 2)).astype(np.float32))
            ang = t(r.uniform(0, 360, 512).astype(np.float32))
            return img, yx, ang

        results["rotated_patch_512x16x16_ms"] = _time(
            lambda im, yx, a: extract_rotated_patches(
                im[None], yx[None], a[None], 16).sum(),
            [rot_args(i) for i in range(4)]) * 1e3

        # PnP
        def pnp_args(seed):
            r = np.random.default_rng(seed)
            X = r.uniform([-2, -2, 4], [2, 2, 10], (512, 3)).astype(
                np.float32)
            uv = X[:, :2] / X[:, 2:]
            return (torch.eye(3, device=dev), torch.zeros(3, device=dev),
                    t(X), t(uv.astype(np.float32)),
                    torch.ones(512, dtype=torch.bool, device=dev))

        results["pnp_ms"] = _time(
            lambda R, t0, X, uv, v: scalar(refine_pose(R, t0, X, uv, v)[:2]),
            [pnp_args(i) for i in range(4)]) * 1e3

    for k, v in results.items():
        print(f"[bench] {k:26s} {v:10.3f}  ({label})", file=sys.stderr)
    print(json.dumps(results))
    with open(out or DEFAULT_OUT, "w") as fh:
        json.dump({"device": label, "image": f"{h}x{w}", **results}, fh,
                  indent=2)
    return results


def _bench_ba(dev, timer) -> dict:
    """One LM iteration at C = 10, L = 4096, O = 16384 (3 problems)."""
    from visualslam_tpu_torch.backend.ba import BAProblem, run_ba
    from visualslam_tpu_torch.utils.config import BAConfig

    C, L, O = 10, 4096, 16384

    def prob(seed):
        r = np.random.default_rng(seed)
        X = r.uniform([-5, -5, 5], [5, 5, 30], (L, 3)).astype(np.float32)
        Rm = np.tile(np.eye(3, dtype=np.float32), (C, 1, 1))
        tc = np.zeros((C, 3), np.float32)
        tc[:, 0] = np.arange(C) * 0.2
        cam = r.integers(0, C, O)
        lm = r.integers(0, L, O)
        pc = X[lm] + tc[cam][:, :]
        uv = pc[:, :2] / pc[:, 2:]
        Xn = X + r.normal(0, 0.05, X.shape).astype(np.float32)
        return BAProblem(
            R=torch.from_numpy(Rm).to(dev), t=torch.from_numpy(tc).to(dev),
            X=torch.from_numpy(Xn).to(dev),
            cam_idx=torch.from_numpy(cam.astype(np.int32)).to(dev),
            lm_idx=torch.from_numpy(lm.astype(np.int32)).to(dev),
            uv=torch.from_numpy(uv.astype(np.float32)).to(dev),
            obs_valid=torch.ones(O, dtype=torch.bool, device=dev),
            cam_valid=torch.ones(C, dtype=torch.bool, device=dev),
            lm_valid=torch.ones(L, dtype=torch.bool, device=dev))

    ba_cfg = BAConfig(iters=1, max_cameras=C, max_landmarks=L,
                      max_observations=O)
    ms = timer(lambda p: run_ba(p, ba_cfg).cost,
               [(prob(i),) for i in range(3)]) * 1e3
    return {"ba_iter_ms": ms, "ba_iters_per_s": 1000.0 / ms}

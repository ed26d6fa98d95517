"""The JAX package's Tracker on the port's sequence features: the figures
chip_smoke.py's sequence, reference and orb phases are bounded by (half
and twice of them).

    python3 chip_smoke.py --save-sequence-features seq_feats.npz \
        --save-reference-features ref_feats.npz \
        --save-orb-features orb_feats.npz
    export JAX_PLATFORMS=cpu PYTHONPATH=.
    python tests/jax_sequence_bounds.py seq_feats.npz
    python tests/jax_sequence_bounds.py ref_feats.npz --profile reference
    python tests/jax_sequence_bounds.py orb_feats.npz --frontend orb
    python tests/jax_sequence_bounds.py seq_feats.npz --sync --seeds 8
    python tests/jax_sequence_bounds.py seq_feats.npz --sync --seeds 8 \
        --tracker port

The npz holds the kernel-path features of the bench sequence's frames
0..55 as the port's tracker detected them (a batch of 8, then batches of
16), the intrinsics and the ground-truth poses. They go through the JAX
Tracker under the config chip_smoke.py ran (--profile fast: FAST_CONFIG,
the default; reference: DEFAULT_CONFIG; --frontend orb: the profile's
config with frontend="orb", whose tracker matches on Hamming distance)
exactly as the port's bench feeds its frames:
process_batch_features over the first batch (bootstrap and two-view init,
then the engine), then over each 16-frame batch (process_stream's result
equals process_batch's, tests/test_torch_tracker.py). Prints one JSON line
of the figures and the bounds derived from them.

--sync runs the window BA synchronously (async_ba=False: the timing of a
Tracker given a mesh). --seeds N runs RANSAC seeds 0..N-1 in place of the
config's one and prints each run's figures, the ATE's median and maximum
over the seeds and the bounds on them (twice each): on these features the
tracker's ATE depends on which inlier set the two-view init's RANSAC
draws, in both packages. --tracker port runs the port's Tracker on the CPU
(its own RANSAC draws) in place of the JAX package's, for comparison.
"""

import argparse
import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from visualslam_tpu.models.types import Features, Keypoints  # noqa: E402
from visualslam_tpu.slam.evaluation import ate_rmse  # noqa: E402
from visualslam_tpu.slam.tracker import Tracker  # noqa: E402
from visualslam_tpu.utils.config import (  # noqa: E402
    DEFAULT_CONFIG,
    FAST_CONFIG,
)


def run(z, cfg, tracker: str) -> dict:
    """One tracker over the saved batches; the figures of frames 0..n-1."""
    sizes = [int(s) for s in z["sizes"]]
    if tracker == "jax":
        t = Tracker(cfg, z["intrinsics"])
    else:
        import torch

        from visualslam_tpu_torch.models.types import Features as PFeatures
        from visualslam_tpu_torch.models.types import Keypoints as PKeypoints
        from visualslam_tpu_torch.slam.tracker import Tracker as PTracker
        from visualslam_tpu_torch.utils.config import SlamConfig

        t = PTracker(SlamConfig.from_json(cfg.to_json()), z["intrinsics"],
                     device="cpu")
    first = 0
    for b, size in enumerate(sizes):
        if tracker == "jax":
            kps = Keypoints(*(jnp.asarray(z[f"b{b}_{k}"])
                              for k in Keypoints._fields))
            fb = Features(kps, jnp.asarray(z[f"b{b}_descriptors"]))
        else:
            kps = PKeypoints(*(torch.as_tensor(z[f"b{b}_{k}"])
                               for k in PKeypoints._fields))
            fb = PFeatures(kps, torch.as_tensor(z[f"b{b}_descriptors"]))
        t.process_batch_features(fb, first, 0, size)
        first += size
    n = first
    frames = t.frames[:n]
    assert [f.frame_id for f in frames] == list(range(n))
    est = t.trajectory()[:n, :, 3]
    inl = [f.num_inliers for f in frames if f.num_inliers > 0]
    return dict(frames=n,
                ok=float(np.mean([f.tracking_ok for f in frames])),
                ate=ate_rmse(est, z["gt_poses"][:n, :, 3]),
                keyframes=int(sum(f.is_keyframe for f in frames)),
                mean_inliers=float(np.mean(inl)), min_inliers=int(min(inl)),
                landmarks=int(t.map.lm_valid.sum()),
                loop_closures=t.num_loop_closures,
                relocalizations=t.relocalizations)


def main(path: str, profile: str = "fast", frontend: str = "sift",
         sync: bool = False, seeds: int = 0, tracker: str = "jax") -> None:
    z = np.load(path)
    cfg = FAST_CONFIG if profile == "fast" else DEFAULT_CONFIG
    cfg = cfg.replace(frontend=frontend)
    if sync:
        cfg = cfg.replace(ba=cfg.ba.replace(async_ba=False))
    if seeds:
        runs = [run(z, cfg.replace(ransac=cfg.ransac.replace(seed=s)),
                    tracker) for s in range(seeds)]
        ate = [r["ate"] for r in runs]
        out = dict(ate_median=float(np.median(ate)), ate_max=max(ate))
        print(json.dumps({tracker: runs, **out,
                          "bounds": {k: 2.0 * v for k, v in out.items()}}))
        return
    fig = run(z, cfg, tracker)
    bounds = dict(ok=0.5 * fig["ok"], ate=2.0 * fig["ate"],
                  keyframes=[fig["keyframes"] // 2, 2 * fig["keyframes"]],
                  mean_inliers=[0.5 * fig["mean_inliers"],
                                2.0 * fig["mean_inliers"]])
    print(json.dumps({tracker: fig, "bounds": bounds}))


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("features")
    p.add_argument("--profile", default="fast", choices=["fast", "reference"])
    p.add_argument("--frontend", default="sift", choices=["sift", "orb"])
    p.add_argument("--sync", action="store_true")
    p.add_argument("--seeds", type=int, default=0)
    p.add_argument("--tracker", default="jax", choices=["jax", "port"])
    a = p.parse_args()
    main(a.features, a.profile, a.frontend, a.sync, a.seeds, a.tracker)

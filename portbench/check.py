"""Whether what the window produced is correct: the numbers below, each
beside its limit in the cell's `limits/<cell>.json` (a cell compares the
numbers its file lists; the others are printed to standard error).

- `sift.*` or `orb.*`: the features the window's frontend returned for
  a sample of its stream batches (drawn from the seed; the first drive's
  and the latest drive's), each valid keypoint judged by the plain
  frontend of the configuration on the same frames (reference/frontend);
- `ate_share.delivered`: for every drive of the window with at least
  MIN_FRAMES tracked poses, the absolute trajectory error of every pose
  the tracker delivered, after a Sim(3) alignment to the path's ground
  truth, as a share of the path's length; the worst drive;
- `dir_err_deg.delivered`: the median angle between the delivered and the
  true displacement over GAP frames; the worst drive;
- `undelivered`: frames handed in whose pose never came (limit 0).
"""

from __future__ import annotations

import numpy as np
import torch

from portbench.reference import ate, frontend

MIN_FRAMES = 24
GAP = 8                 # frames between the displacements compared


def sample_batches(seed: int, n_batches: int, k: int) -> list:
    rng = np.random.default_rng(seed)
    return sorted(int(i) for i in rng.choice(n_batches, size=min(k,
                                                                 n_batches),
                                             replace=False))


def padded(imgs: np.ndarray, batch: int) -> np.ndarray:
    """The batch as the tracker runs it: a short batch repeats its last
    frame."""
    n = len(imgs)
    if n >= batch:
        return imgs
    return np.concatenate([imgs, np.repeat(imgs[-1:], batch - n, axis=0)])


def frontend_numbers(seq, captures: dict, cfg_dict: dict, device,
                     control: bool = False) -> dict:
    """The worst numbers of the captured batches' frames, judged by the
    plain frontend (reference/frontend.py); with control=True those of
    the control put in the program's place."""
    worst: dict = {}
    for (_, i), feats in captures.items():
        frames = torch.from_numpy(np.ascontiguousarray(seq.batches[i][1]))
        got = frontend.numbers(frames.to(device), feats, cfg_dict, control)
        for k, v in got.items():
            worst[k] = max(worst.get(k, 0.0), v)
    return worst


def _share(centers: np.ndarray, gt: np.ndarray) -> float:
    return ate.ate_rmse(centers, gt) / max(ate.path_length(gt), 1e-9)


def dir_err_deg(fids, est: np.ndarray, gt: np.ndarray, gap: int) -> float:
    """Median angle (degrees) between the estimated and the true
    displacement of the camera from each frame to the frame `gap` later
    (pairs where both were tracked; a displacement of zero reads 180)."""
    at = {int(f): k for k, f in enumerate(fids)}
    angles = []
    for f, k in at.items():
        j = at.get(f + gap)
        if j is None:
            continue
        a, b = est[j] - est[k], gt[j] - gt[k]
        na, nb = np.linalg.norm(a), np.linalg.norm(b)
        if na < 1e-12:
            angles.append(180.0)
            continue
        c = float(np.clip(a @ b / (na * nb), -1.0, 1.0))
        angles.append(float(np.degrees(np.arccos(c))))
    return float(np.median(angles)) if angles else 0.0


def pose_numbers(rec, gt_centers: np.ndarray) -> dict:
    """The poses of the window's drives against the ground truth: the
    worst drive's ATE share and median direction error of the delivered
    poses (frames GAP apart)."""
    out = {"ate_share.delivered": 0.0, "dir_err_deg.delivered": 0.0}
    for d in rec.drives:
        fids = sorted(f for f, ok in d.ok.items() if ok)
        if len(fids) < MIN_FRAMES:
            continue
        R = np.stack([d.poses[f][0] for f in fids])
        t = np.stack([d.poses[f][1] for f in fids])
        est = ate.centers_of_world_to_camera(R, t)
        gt = gt_centers[fids]
        out["ate_share.delivered"] = max(out["ate_share.delivered"],
                                         _share(est, gt))
        out["dir_err_deg.delivered"] = max(out["dir_err_deg.delivered"],
                                           dir_err_deg(fids, est, gt, GAP))
    return out


def verdict(numbers: dict, limits: dict) -> tuple:
    """(correct, [(name, value, limit)]) over the cell's limits: every
    number at most its limit; a number that is missing or not a number
    fails. Numbers without a limit are not compared."""
    rows, ok = [], True
    for name, limit in limits.items():
        value = numbers.get(name, float("nan"))
        ok &= value == value and value <= limit
        rows.append((name, value, limit))
    return ok, rows

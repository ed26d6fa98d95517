"""Trajectory evaluation: ATE / RPE with Sim(3) (Umeyama) alignment
(visualslam_tpu/slam/evaluation.py, copied: the JAX package imports jax at
package import, and this module is numpy only).

The reference has no evaluation machinery; BASELINE.json's metric demands
"ATE delta vs reference" — monocular trajectories are up-to-scale, so ATE is
computed after a similarity alignment (the standard KITTI/TUM protocol for
monocular methods)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = True):
    """Least-squares similarity transform: dst ~ s * R @ src + t.

    src, dst: [N, 3]. Returns (s, R [3,3], t [3])."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs**2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s) if with_scale else 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray,
             align_scale: bool = True) -> float:
    """Absolute trajectory error (RMSE of aligned camera centers)."""
    s, R, t = umeyama_alignment(est_centers, gt_centers,
                                with_scale=align_scale)
    aligned = est_centers @ (s * R).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(axis=1).mean()))


def rpe(est_poses: np.ndarray, gt_poses: np.ndarray, delta: int = 1):
    """Relative pose error over frame gaps of `delta`.

    poses: [F, 3, 4] camera-to-world. Returns (trans_rmse, rot_rmse_deg)."""
    def rel(P, i, j):
        Ra, ca = P[i, :, :3], P[i, :, 3]
        Rb, cb = P[j, :, :3], P[j, :, 3]
        Rr = Ra.T @ Rb
        tr = Ra.T @ (cb - ca)
        return Rr, tr

    terrs, rerrs = [], []
    F = len(est_poses)
    for i in range(F - delta):
        Re, te = rel(est_poses, i, i + delta)
        Rg, tg = rel(gt_poses, i, i + delta)
        dR = Re.T @ Rg
        cos = np.clip((np.trace(dR) - 1) / 2, -1, 1)
        rerrs.append(np.degrees(np.arccos(cos)))
        terrs.append(np.linalg.norm(te - tg))
    return (float(np.sqrt(np.mean(np.square(terrs)))),
            float(np.sqrt(np.mean(np.square(rerrs)))))


def centers_from_poses(poses: np.ndarray) -> np.ndarray:
    """[F, 3, 4] camera-to-world -> [F, 3] camera centers."""
    return poses[:, :, 3]

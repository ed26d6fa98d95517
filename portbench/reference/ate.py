"""Absolute trajectory error after a Sim(3) (Umeyama) alignment, the
KITTI / TUM protocol for monocular trajectories (a copy of the arithmetic
of the port's `slam/evaluation.py`)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray):
    """Least-squares similarity dst ~ s R src + t for [N, 3] point sets.
    Returns (s, R, t)."""
    mu_s, mu_d = src.mean(0), dst.mean(0)
    xs, xd = src - mu_s, dst - mu_d
    cov = xd.T @ xs / len(src)
    U, D, Vt = np.linalg.svd(cov)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    R = U @ S @ Vt
    var_s = (xs ** 2).sum() / len(src)
    s = float(np.trace(np.diag(D) @ S) / var_s)
    return s, R, mu_d - s * R @ mu_s


def ate_rmse(est_centers: np.ndarray, gt_centers: np.ndarray) -> float:
    """RMSE of the aligned camera centers."""
    s, R, t = umeyama_alignment(est_centers, gt_centers)
    aligned = est_centers @ (s * R).T + t
    return float(np.sqrt(((aligned - gt_centers) ** 2).sum(axis=1).mean()))


def path_length(centers: np.ndarray) -> float:
    return float(np.linalg.norm(np.diff(centers, axis=0), axis=1).sum())


def centers_of_world_to_camera(R: np.ndarray, t: np.ndarray) -> np.ndarray:
    """Camera centers -R^T t of world-to-camera poses R [N, 3, 3],
    t [N, 3]."""
    return -np.einsum("nji,nj->ni", R, t)

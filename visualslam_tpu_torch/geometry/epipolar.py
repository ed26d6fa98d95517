"""Epipolar geometry (visualslam_tpu/geometry/epipolar.py): the 8-point
essential matrix, Sampson error, pose recovery and DLT triangulation.

Conventions: x in normalized camera coords, x2^T E x1 = 0; (R, t) maps
points from the camera-1 frame to the camera-2 frame, X2 = R X1 + t.

`eight_point` and `sampson_error` batch over leading axes (RANSAC solves
and scores all its hypotheses in one call, where the JAX package vmaps).
Everything runs at float32 matmul precision (TF32 off,
utils/precision.f32_matmul), as the reference. Singular and eigen vectors
carry a sign freedom, so E is defined up to sign: compare E up to sign and
the chosen pose, not the factors.

The small solves take `kernels`: ops.cuda.KERNELS (the Jacobi kernels
`sym_eigh`, `svd3` and `triangulate_dlt`, no host sync, so RANSAC and pose
recovery capture into a CUDA graph) or ops.cuda.PLAIN (`torch.linalg`,
which on the card reads cuSOLVER's status on the host). The 3x3
determinants whose sign makes the decomposition's factors rotations are
closed-form. The constant matrices are built once per device and dtype
(`_constant`), never inside a capture: a copy from host memory there would
raise or bake a pointer into the graph.
"""

from __future__ import annotations

import functools
import math

import torch

from visualslam_tpu_torch.geometry.fivepoint import _det3
from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.precision import f32_matmul

_EPS = 1e-12
_CONSTANTS = {
    # the projection onto the essential manifold: singular values (1, 1, 0)
    "diag110": [1.0, 1.0, 0.0],
    # the decomposition's rotation by 90 degrees about z
    "W": [[0.0, -1.0, 0.0], [1.0, 0.0, 0.0], [0.0, 0.0, 1.0]],
}


@functools.lru_cache(maxsize=None)
def _constant(name: str, device: torch.device,
              dtype: torch.dtype) -> torch.Tensor:
    """_CONSTANTS[name] on device, built on first use there (outside any
    capture: the warm-up of a captured program makes it)."""
    return torch.tensor(_CONSTANTS[name], dtype=dtype, device=device)


def _normalize_pts(x: torch.Tensor, w: torch.Tensor):
    """Hartley normalization with weights: center + sqrt(2) mean distance.

    x: [..., N, 2]; w: [..., N] sample weights (0/1 mask). Returns
    (xn [..., N, 2], T [..., 3, 3]) with xn = T * x in homogeneous terms."""
    wsum = w.sum(-1).clamp_min(_EPS)                          # [...]
    mean = (x * w[..., None]).sum(-2) / wsum[..., None]       # [..., 2]
    d = torch.sqrt(((x - mean[..., None, :]) ** 2).sum(-1))
    mean_d = (d * w).sum(-1) / wsum
    s = math.sqrt(2.0) / mean_d.clamp_min(_EPS)
    xn = (x - mean[..., None, :]) * s[..., None, None]
    z, o = torch.zeros_like(s), torch.ones_like(s)
    T = torch.stack([
        torch.stack([s, z, -s * mean[..., 0]], -1),
        torch.stack([z, s, -s * mean[..., 1]], -1),
        torch.stack([z, z, o], -1),
    ], -2)
    return xn, T


def eight_point(x1: torch.Tensor, x2: torch.Tensor,
                w: torch.Tensor | None = None,
                kernels: Kernels = KERNELS) -> torch.Tensor:
    """Weighted 8-point essential estimate.

    x1, x2: [..., N >= 8, 2] correspondences in normalized camera coords;
    w: [..., N] weights (mask). Returns E [..., 3, 3] with x2^T E x1 = 0,
    projected to the essential manifold (singular values (1, 1, 0)):
    `kernels.sym_eigh` of the 9x9 normal matrices, `kernels.svd3` of the
    denormalized F."""
    f32_matmul()
    if w is None:
        w = torch.ones(x1.shape[:-1], dtype=x1.dtype, device=x1.device)
    x1n, T1 = _normalize_pts(x1, w)
    x2n, T2 = _normalize_pts(x2, w)
    u1, v1 = x1n[..., 0], x1n[..., 1]
    u2, v2 = x2n[..., 0], x2n[..., 1]
    ones = torch.ones_like(u1)
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2, u1, v1,
                     ones], -1)                              # [..., N, 9]
    Aw = A * w[..., None]
    M = Aw.transpose(-1, -2) @ Aw                            # [..., 9, 9]
    _, evecs = kernels.sym_eigh(M)
    F = evecs[..., :, 0].reshape(*M.shape[:-2], 3, 3)       # smallest eigval
    F = T2.transpose(-1, -2) @ F @ T1                       # denormalize
    U, _, Vt = kernels.svd3(F)
    return (U * _constant("diag110", F.device, F.dtype)) @ Vt


def sampson_error(E: torch.Tensor, x1: torch.Tensor,
                  x2: torch.Tensor) -> torch.Tensor:
    """First-order geometric (Sampson) error. E [..., 3, 3]; x1, x2:
    [..., N, 2] normalized coords. Returns [..., N] squared errors."""
    ones = torch.ones_like(x1[..., :1])
    p1 = torch.cat([x1, ones], -1)                           # [..., N, 3]
    p2 = torch.cat([x2, ones], -1)
    Ex1 = p1 @ E.transpose(-1, -2)                           # (E p1^T)^T
    Etx2 = p2 @ E
    num = (p2 * Ex1).sum(-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    return num / den.clamp_min(_EPS)


def triangulate(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                x2: torch.Tensor, kernels: Kernels = KERNELS) -> torch.Tensor:
    """Linear (DLT) triangulation in camera-1 frame: the eigenvector of the
    smallest eigenvalue of each point's 4x4 normal matrix. R, t: relative
    pose; x1, x2: [N, 2] normalized coords. Returns X [N, 3].

    `kernels.triangulate_dlt`: the Jacobi kernel on the card (no host
    sync) or the plain `torch.linalg.eigh` version
    (ops/cuda/triangulate.py). The reference runs at float32 matmul
    precision; so does the plain version. Two eigensolvers may pick
    different eigenvectors of a near-degenerate normal matrix (a point
    near infinity): compare such points only where both accept them."""
    return kernels.triangulate_dlt(R, t, x1, x2)


def decompose_essential(E: torch.Tensor, kernels: Kernels = KERNELS):
    """E -> ((R1, R2), t) candidate decompositions (4 combos with +-t).
    The SVD is `kernels.svd3`; the factors' determinants are closed-form
    (only their sign is read, of orthonormal matrices)."""
    f32_matmul()
    U, _, Vt = kernels.svd3(E)
    # enforce proper rotations
    U = U * torch.sign(_det3(U))
    Vt = Vt * torch.sign(_det3(Vt))
    W = _constant("W", E.device, E.dtype)
    return (U @ W @ Vt, U @ W.T @ Vt), U[:, 2]


def recover_pose(E: torch.Tensor, x1: torch.Tensor, x2: torch.Tensor,
                 w: torch.Tensor, kernels: Kernels = KERNELS):
    """Pick the (R, t) among the 4 decompositions with max cheirality
    support (the first on ties). Returns (R, t, X [N, 3], front_mask [N]).
    The winner is taken with index_select (indexing by a 0-d tensor reads
    it on the host)."""
    (R1, R2), tt = decompose_essential(E, kernels)
    Rs = torch.stack([R1, R1, R2, R2])
    ts = torch.stack([tt, -tt, tt, -tt])
    scores, Xs, fronts = [], [], []
    for R, t in zip(Rs, ts):
        X = triangulate(R, t, x1, x2, kernels)
        X2 = X @ R.T + t
        front = (X[..., 2] > _EPS) & (X2[..., 2] > _EPS)
        scores.append((front * w).sum())
        Xs.append(X)
        fronts.append(front)
    best = torch.argmax(torch.stack(scores)).reshape(1)  # first maximum
    return tuple(x.index_select(0, best)[0] for x in (
        Rs, ts, torch.stack(Xs), torch.stack(fronts)))

"""DLT triangulation: the CUDA kernel's wrapper, its float32 replay and its
plain PyTorch version.

The JAX package triangulates with `jnp.linalg.eigh` of each point's 4x4
normal matrix (visualslam_tpu/geometry/epipolar.py `_triangulate_highp`;
no Pallas kernel). The plain version here does the same with
`torch.linalg.eigh`, which on the card is cuSOLVER's batched eigensolver
followed by a host read of its error flags: one host sync per call, and a
CUDA graph cannot capture it. The kernel (csrc/triangulate.cu) solves each
point's matrix by cyclic Jacobi on four lanes (each holding the whole
matrix and one row of the eigenvectors), one launch and no host read, so a
keyframe promotion captures.

`triangulate_jacobi` repeats the kernel's arithmetic operation for
operation (every product, sum, quotient and square root rounded to float32
on its own, as the kernel's `__f*_rn` intrinsics round them, by way of
float64), on any device: the CPU tests hold it against the JAX package,
and the card's tests hold the kernel against it, run on the CPU, bit for
bit.

The smallest eigenvector of a normal matrix whose two smallest eigenvalues
lie close (a point near infinity, or one seen under little parallax) is
ill-conditioned: two eigensolvers may return different vectors there. A
comparison of two solvers is therefore gated by the relative gap
(lambda_1 - lambda_0) / lambda_3 of the matrix and holds the unit
eigenvectors to `VEC_TOL` x float32 epsilon / gap (`eigen_gap`,
`compare_solvers`).

`triangulate_dlt` launches the kernel for CUDA tensors and runs the plain
version for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from visualslam_tpu_torch.ops.cuda import build
from visualslam_tpu_torch.utils.precision import f32_matmul

_EPS = 1e-12        # |w| clamp (geometry/epipolar.py _EPS; kEps in the .cu)
# Jacobi sweeps: cyclic Jacobi converges quadratically. On every normal
# matrix of the tests' triangulations (tests/test_torch_triangulate.py) the
# relative off-diagonal norm is ~0.3 after one sweep, ~1e-2 after two, at
# float32 epsilon (~1e-7) after three and below 1e-20 after four, and the
# points no longer change; the fifth is margin. chip_smoke.py reads the
# same norms on the card's triangulations.
SWEEPS = 5
PAIRS = ((0, 1), (0, 2), (0, 3), (1, 2), (1, 3), (2, 3))
# solvers compared: points whose relative eigengap is at least GAP_MIN,
# unit eigenvectors (w >= 0) within VEC_TOL * eps32 / gap
GAP_MIN = 1e-5
VEC_TOL = 32.0
EPS32 = float(np.finfo(np.float32).eps)


def _dlt_rows(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
              x2: torch.Tensor) -> torch.Tensor:
    """The [N, 4, 4] DLT matrices of the point pairs."""
    zeros = torch.zeros((3, 1), dtype=R.dtype, device=R.device)
    P1 = torch.cat([torch.eye(3, dtype=R.dtype, device=R.device), zeros], 1)
    P2 = torch.cat([R, t[:, None]], 1)                       # [3, 4]

    def rows(P, x):
        # rows: x * P3 - P1 ; y * P3 - P2
        return torch.stack([x[..., 0, None] * P[2] - P[0],
                            x[..., 1, None] * P[2] - P[1]], -2)

    return torch.cat([rows(P1, x1), rows(P2, x2)], -2)


def _dehomogenize(Xh: torch.Tensor) -> torch.Tensor:
    """Unit 4-vectors with w >= 0 -> points: divide by w clamped to _EPS
    where |w| < _EPS."""
    w = Xh[..., 3:]
    return Xh[..., :3] / torch.where(w.abs() < _EPS, torch.full_like(w, _EPS),
                                     w)


def normal_matrices(R, t, x1, x2) -> torch.Tensor:
    """M = A^T A [N, 4, 4], by a batched matrix product (the plain
    version's)."""
    f32_matmul()
    A = _dlt_rows(R, t, x1, x2)
    return A.transpose(-1, -2) @ A


def triangulate_ref(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Plain version: linear (DLT) triangulation in camera-1 frame, the
    eigenvector of the smallest eigenvalue of each point's 4x4 normal
    matrix (`torch.linalg.eigh`). R, t: relative pose (X2 = R X1 + t); x1,
    x2: [N, 2] normalized coords. Returns X [N, 3]. Float32 matmul
    precision (TF32 off), as the reference."""
    return _dehomogenize(unit_vectors_ref(R, t, x1, x2))


def _rn(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest float32, held in float64. An operation on
    float32 values done in float64 and rounded so gives the correctly
    rounded float32 result (53 >= 2 x 24 + 2 bits: double rounding is
    innocuous for +, -, x, / and sqrt), on any device; torch's own float32
    square root and quotients on the CPU are not always correctly rounded
    (against the card's: 6% of the points' bits parted)."""
    return x.float().double()


def _jacobi(a: torch.Tensor, sweeps: int, offs: list | None = None):
    """Cyclic Jacobi on symmetric a [N, 4, 4] (float32 values in float64)
    in the kernel's operation order, each operation rounded to float32.
    Returns (a, V); offs, if given, collects the relative off-diagonal
    norm after each sweep."""
    v = torch.eye(4, dtype=a.dtype, device=a.device).expand_as(a).clone()
    a = a.clone()
    one = torch.ones_like(a[:, 0, 0])
    for _ in range(sweeps):
        for p, q in PAIRS:
            apq = a[:, p, q]
            theta = _rn(torch.div(_rn(a[:, q, q] - a[:, p, p]), 2.0 * apq))
            t = _rn(torch.div(one, _rn(theta.abs() + _rn(torch.sqrt(
                _rn(_rn(theta * theta) + 1.0))))))
            t = torch.where(theta < 0, -t, t)
            c = _rn(torch.div(one, _rn(torch.sqrt(_rn(_rn(t * t) + 1.0)))))
            s = _rn(t * c)
            tau = _rn(torch.div(s, _rn(1.0 + c)))
            h = _rn(t * apq)
            na, nv = a.clone(), v.clone()
            na[:, p, p] = _rn(a[:, p, p] - h)
            na[:, q, q] = _rn(a[:, q, q] + h)
            na[:, p, q] = 0.0
            na[:, q, p] = 0.0
            for r in range(4):
                if r in (p, q):
                    continue
                g, hh = a[:, r, p], a[:, r, q]
                np_ = _rn(g - _rn(s * _rn(hh + _rn(g * tau))))
                nq = _rn(hh + _rn(s * _rn(g - _rn(hh * tau))))
                na[:, r, p] = np_
                na[:, p, r] = np_
                na[:, r, q] = nq
                na[:, q, r] = nq
            for r in range(4):
                g, hh = v[:, r, p], v[:, r, q]
                nv[:, r, p] = _rn(g - _rn(s * _rn(hh + _rn(g * tau))))
                nv[:, r, q] = _rn(hh + _rn(s * _rn(g - _rn(hh * tau))))
            keep = (apq == 0)[:, None, None]
            a = torch.where(keep, a, na)
            v = torch.where(keep, v, nv)
        if offs is not None:
            off = a - torch.diag_embed(torch.diagonal(a, dim1=1, dim2=2))
            offs.append((torch.linalg.vector_norm(off, dim=(1, 2))
                         / torch.linalg.vector_norm(a, dim=(1, 2))
                         .clamp_min(1e-300)).float())
    return a, v


def triangulate_jacobi(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                       x2: torch.Tensor, sweeps: int = SWEEPS,
                       offs: list | None = None,
                       vectors: bool = False):
    """The kernel's arithmetic, replayed with torch operations on any
    device: same DLT rows, M's rows added in order 0..3, `sweeps` cyclic
    Jacobi sweeps, the first smallest diagonal entry's column, the sign and
    the clamped division, every operation rounded to float32 as the
    kernel's. Returns X [N, 3] float32 (and the unit eigenvectors [N, 4]
    with w >= 0 when `vectors`)."""
    R, t, x1, x2 = (x.float().double() for x in (R, t, x1, x2))
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = torch.cat([eye, torch.zeros_like(eye[:, :1])], 1)
    P2 = torch.cat([R, t[:, None]], 1)

    def rows(P, x):
        return torch.stack([_rn(_rn(x[:, 0, None] * P[2]) - P[0]),
                            _rn(_rn(x[:, 1, None] * P[2]) - P[1])], -2)

    A = torch.cat([rows(P1, x1), rows(P2, x2)], -2)           # [N, 4, 4]
    prod = _rn(A[:, :, :, None] * A[:, :, None, :])          # [N, r, j, k]
    a = prod[:, 0]
    for r in range(1, 4):
        a = _rn(a + prod[:, r])
    a, v = _jacobi(a, sweeps, offs)
    best = a[:, 0, 0]
    e = v[:, :, 0]
    for k in range(1, 4):
        take = a[:, k, k] < best
        best = torch.where(take, a[:, k, k], best)
        e = torch.where(take[:, None], v[:, :, k], e)
    e = torch.where((e[:, 3] < 0)[:, None], -e, e)
    w = e[:, 3:]
    w = torch.where(w.abs() < float(np.float32(_EPS)),
                    torch.full_like(w, float(np.float32(_EPS))), w)
    X = torch.div(e[:, :3], w).float()
    return (X, e.float()) if vectors else X


def unit_vectors_ref(R, t, x1, x2) -> torch.Tensor:
    """The plain version's unit eigenvectors [N, 4], w >= 0."""
    _, evecs = torch.linalg.eigh(normal_matrices(R, t, x1, x2))
    Xh = evecs[..., 0]
    return torch.where((Xh[..., 3] < 0)[..., None], -Xh, Xh)


def eigen_gap(M) -> np.ndarray:
    """Relative gap (lambda_1 - lambda_0) / lambda_3 of each normal matrix
    [N, 4, 4] (any array; eigenvalues in float64)."""
    lam = np.linalg.eigvalsh(np.asarray(M, np.float64))
    return (lam[:, 1] - lam[:, 0]) / np.maximum(lam[:, 3], 1e-300)


def compare_solvers(va, vb, gap) -> tuple:
    """(points compared, worst |va - vb| * gap / eps32, its bound VEC_TOL)
    of two solvers' unit eigenvectors [N, 4] (w >= 0) over the points
    whose relative gap is at least GAP_MIN. A vector whose w is 0 to
    rounding has no sign to fix, so the two signs are both tried."""
    va = np.asarray(va, np.float64)
    vb = np.asarray(vb, np.float64)
    gate = np.asarray(gap) >= GAP_MIN
    d = np.minimum(np.linalg.norm(va - vb, axis=1),
                   np.linalg.norm(va + vb, axis=1))
    score = d[gate] * np.asarray(gap)[gate] / EPS32
    return int(gate.sum()), float(score.max(initial=0.0)), VEC_TOL


def triangulate_dlt(R: torch.Tensor, t: torch.Tensor, x1: torch.Tensor,
                    x2: torch.Tensor) -> torch.Tensor:
    """Linear (DLT) triangulation, X [N, 3] in camera-1 frame, of the pairs
    x1, x2 [N, 2] under the relative pose R [3, 3], t [3]. Same contract
    as `triangulate_ref`."""
    if all(x.device.type == "cpu" for x in (R, t, x1, x2)):
        return triangulate_ref(R, t, x1, x2)
    dev = x1.device
    if dev.type != "cuda" or any(x.device != dev for x in (R, t, x2)):
        raise ValueError(f"triangulate_dlt: unsupported devices {R.device}, "
                         f"{t.device}, {x1.device}, {x2.device}")
    n = x1.shape[0]
    if (any(x.dtype != torch.float32 for x in (R, t, x1, x2))
            or R.shape != (3, 3) or t.shape != (3,)
            or x1.shape != (n, 2) or x2.shape != (n, 2)):
        raise ValueError(
            "triangulate_dlt: expects float32 R [3, 3], t [3], x1 and x2 "
            f"[N, 2], got {R.dtype} {tuple(R.shape)}, {t.dtype} "
            f"{tuple(t.shape)}, {x1.dtype} {tuple(x1.shape)}, {x2.dtype} "
            f"{tuple(x2.shape)}")
    R, t, x1, x2 = (x.contiguous() for x in (R, t, x1, x2))
    out = torch.empty((n, 3), dtype=torch.float32, device=dev)
    if n == 0:
        return out
    with build.on_device(dev):
        rc = _lib().triangulate_dlt(R.data_ptr(), t.data_ptr(),
                                    x1.data_ptr(), x2.data_ptr(),
                                    out.data_ptr(), n, SWEEPS,
                                    build.stream_handle(dev))
    build.check_launch(rc, "triangulate_dlt")
    triangulate_dlt.launches += 1
    return out


triangulate_dlt.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("triangulate")
    fn = lib.triangulate_dlt
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib

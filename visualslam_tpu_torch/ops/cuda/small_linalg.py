"""Batched small-matrix eigendecomposition and 3x3 SVD: the CUDA kernels'
wrappers, their float32 replays and their plain PyTorch versions.

The JAX package solves the two-view init's small systems with
`jnp.linalg.eigh`, `svd` and `det` (visualslam_tpu/geometry/epipolar.py
`_eight_point_highp`, `decompose_essential`; geometry/fivepoint.py
`five_point`; no Pallas kernel). The plain versions here are the same
`torch.linalg` calls. On the card each is cuSOLVER's batched solver
followed by a host read of its error flags: one host sync per call, and a
CUDA graph cannot capture it. The kernels (csrc/small_linalg.cu) solve each
matrix by cyclic Jacobi (on a group of lanes, each holding the whole
matrix and one row of the eigenvectors: for sym_eigh n rounded up to a
power of two, for svd3 a warp), one launch and no host read, so the init
captures.

  sym_eigh(M)   symmetric [..., n, n] float32, n <= 10 -> (w [..., n]
                ascending, V [..., n, n] eigenvectors as columns):
                torch.linalg.eigh's contract (lower triangle read)
  svd3(A)       [..., 3, 3] float32 -> (U, S [..., 3] descending, Vh):
                torch.linalg.svd's contract; U[..., 2] = +-U[..., 0] x
                U[..., 1] (the matrices have rank two: csrc/small_linalg.cu)

Both kernels take and give float32; every product, sum, quotient and
square root is rounded on its own (the `__f*_rn` / `__d*_rn`
intrinsics). svd3 computes in float32. sym_eigh computes in float64 and
rounds to float32 once at the end: a float32 solver fixes the smallest
eigenvectors of its normal matrices only to ~eps32 x cond^2
(csrc/small_linalg.cu; the CPU tests measure it against float64).
`sym_eigh_jacobi` and `svd3_jacobi` repeat the kernels' arithmetic
operation for operation with torch's float64 operations (svd3's each
rounded to float32 after, which gives the correctly rounded float32
result), on any device: the CPU tests hold them against the JAX package,
and the card's tests hold the kernels against them, run on the CPU, bit
for bit. Their `ops` argument runs the other precision instead, which no
kernel computes: the tests and `init_variants` compare the two.

Eigenvectors of near-equal eigenvalues are ill-conditioned, and any
orthonormal basis of a degenerate eigenspace is right (the five-point
solver's 4-D nullspace): two solvers are compared by eigenvalue within
EIG_TOL x max |lambda|, and by the projector onto each cluster of
eigenvalues (neighbours closer than GAP_MIN x max |lambda| join one) within
VEC_TOL x float32 epsilon / gap (`compare_eigh`, `compare_svd3`), as
ops/cuda/triangulate.py gates its eigenvectors.

`sym_eigh` and `svd3` launch the kernels for CUDA tensors and run the plain
versions for CPU tensors; anything else raises.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from visualslam_tpu_torch.ops.cuda import build
from visualslam_tpu_torch.ops.cuda.triangulate import EPS32, GAP_MIN, VEC_TOL

MAX_N = 10          # the largest n sym_eigh's launcher dispatches
# Jacobi sweeps. Cyclic Jacobi converges quadratically once it is close; the
# counts are those after which the largest relative off-diagonal norm of
# every matrix of the tests' and the card's two-view inits lies below
# float32 epsilon, plus one as margin. Over 40 synthetic scenes (baselines
# and depth ranges varied, 128 five-point and 256 eight-point samples each)
# the five-point 10x10 systems took up to 9 sweeps, its 9x9 nullspace
# systems and the 8-point normal matrices 7, the SVDs' 3x3 A^T A 4
# (PERF.md; chip_smoke.py prints the norms per sweep on the card's
# matrices, and tests/test_torch_small_linalg.py checks the rule).
EIGH_SWEEPS = 10
SVD_SWEEPS = 5
EIG_TOL = 1e-5      # eigen / singular values, x max |lambda| or sigma_1

# ---------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------


def sym_eigh_ref(M: torch.Tensor):
    """Plain version: torch.linalg.eigh (on the card cuSOLVER, then a host
    read of its status). Returns (w, V)."""
    w, V = torch.linalg.eigh(M)
    return w, V


def svd3_ref(A: torch.Tensor):
    """Plain version: torch.linalg.svd (on the card cuSOLVER, then a host
    read of its status). Returns (U, S, Vh)."""
    U, S, Vh = torch.linalg.svd(A)
    return U, S, Vh


# ---------------------------------------------------------------------
# float32 replays
# ---------------------------------------------------------------------


def _rn32(x: torch.Tensor) -> torch.Tensor:
    """x rounded to the nearest float32, held in float64: a +, -, x, / or
    sqrt of float32 values done in float64 and rounded so is the correctly
    rounded float32 result (53 >= 2 x 24 + 2 bits)."""
    return x.float().double()


def _exact(x: torch.Tensor) -> torch.Tensor:
    """float64 arithmetic: each torch operation is already rounded once."""
    return x


def _sqrt(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float64 square root (the card's __dsqrt_rn).
    torch's own on the CPU is not always (7609 of 10^6 random values one
    ulp off, torch 2.13): numpy's is the hardware's."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.numpy()))
    return torch.sqrt(x)


def _rotate(a: torch.Tensor, v: torch.Tensor, p: int, q: int, rn):
    """One Jacobi rotation zeroing a[:, p, q] (float64 values, each
    operation rounded by rn), in the kernels' operation order; a matrix
    whose a[p][q] is 0 is left as it is."""
    apq, app, aqq = a[:, p, q], a[:, p, p], a[:, q, q]
    theta = rn(rn(aqq - app) / rn(2.0 * apq))
    t = rn(torch.reciprocal(rn(theta.abs() + rn(_sqrt(
        rn(rn(theta * theta) + 1.0))))))
    t = torch.where(theta < 0, -t, t)
    c = rn(torch.reciprocal(rn(_sqrt(rn(rn(t * t) + 1.0)))))
    s = rn(t * c)
    tau = rn(s / rn(1.0 + c))
    h = rn(t * apq)
    s, tau = s[:, None], tau[:, None]

    def rot(g, hh):
        return (rn(g - rn(s * rn(hh + rn(g * tau)))),
                rn(hh + rn(s * rn(g - rn(hh * tau)))))

    na, nv = a.clone(), v.clone()
    np_, nq = rot(a[:, :, p], a[:, :, q])
    na[:, :, p] = np_
    na[:, p, :] = np_
    na[:, :, q] = nq
    na[:, q, :] = nq
    na[:, p, p] = rn(app - h)
    na[:, q, q] = rn(aqq + h)
    na[:, p, q] = 0.0
    na[:, q, p] = 0.0
    nv[:, :, p], nv[:, :, q] = rot(v[:, :, p], v[:, :, q])
    keep = (apq == 0)[:, None, None]
    return torch.where(keep, a, na), torch.where(keep, v, nv)


def _off_norm(a: torch.Tensor) -> torch.Tensor:
    """Relative off-diagonal norm of each matrix [B, n, n]."""
    off = a - torch.diag_embed(torch.diagonal(a, dim1=1, dim2=2))
    return (torch.linalg.vector_norm(off, dim=(1, 2))
            / torch.linalg.vector_norm(a, dim=(1, 2)).clamp_min(1e-300))


def _jacobi(a: torch.Tensor, sweeps: int, rn, offs: list | None = None,
            done: list | None = None):
    """`sweeps` cyclic Jacobi sweeps (pairs row by row) on symmetric a
    [B, n, n] (float64 values, each operation rounded by rn). Returns (a,
    V); offs, if given,
    collects the relative off-diagonal norm before the first sweep and
    after each, and done the rotations each sweep carried out over the
    batch (a zero pivot's is skipped)."""
    n = a.shape[-1]
    v = torch.eye(n, dtype=a.dtype, device=a.device).expand_as(a).clone()
    if offs is not None:
        offs.append(_off_norm(a).float())
    for _ in range(sweeps):
        rotated = 0
        for p in range(n - 1):
            for q in range(p + 1, n):
                if done is not None:
                    rotated += int((a[:, p, q] != 0).sum())
                a, v = _rotate(a, v, p, q, rn)
        if offs is not None:
            offs.append(_off_norm(a).float())
        if done is not None:
            done.append(rotated)
    return a, v


def _rounding(ops: torch.dtype):
    if ops not in (torch.float32, torch.float64):
        raise ValueError(f"ops: float32 or float64, got {ops}")
    return _rn32 if ops == torch.float32 else _exact


def sym_eigh_jacobi(M: torch.Tensor, sweeps: int = EIGH_SWEEPS,
                    offs: list | None = None, done: list | None = None,
                    ops: torch.dtype = torch.float64):
    """The sym_eigh kernel's arithmetic, replayed with torch's float64
    operations on any device: M's float32 values, the lower triangle
    mirrored, `sweeps` cyclic Jacobi sweeps in float64, the diagonal sorted
    ascending by a stable rank (NaN last), rounded to float32 once.
    Returns (w, V), M's shapes. ops=torch.float32 rounds every operation to
    float32 instead (not the kernel's arithmetic: what the tests hold the
    kernel's choice of float64 against)."""
    shape = M.shape
    n = shape[-1]
    m = M.reshape(-1, n, n).float().double()
    lower = torch.ones(n, n, dtype=torch.bool, device=M.device).tril()
    a, v = _jacobi(torch.where(lower, m, m.transpose(-1, -2)), sweeps,
                   _rounding(ops), offs, done)
    d = torch.diagonal(a, dim1=1, dim2=2)
    key = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
    order = torch.sort(key, dim=-1, stable=True).indices
    w = d.gather(-1, order)
    V = v.gather(-1, order[:, None, :].expand_as(v))
    return w.float().reshape(shape[:-1]), V.float().reshape(shape)


def _sum3(prod: torch.Tensor, dim: int, rn) -> torch.Tensor:
    """Sum of the 3 entries along dim in order 0, 1, 2, each add rounded
    by rn."""
    return rn(rn(prod.select(dim, 0) + prod.select(dim, 1))
              + prod.select(dim, 2))


def svd3_jacobi(A: torch.Tensor, sweeps: int = SVD_SWEEPS,
                offs: list | None = None, done: list | None = None,
                ops: torch.dtype = torch.float32):
    """The svd3 kernel's arithmetic, replayed with torch operations on any
    device, each rounded to float32 as the kernel's: B = A^T A, `sweeps`
    Jacobi sweeps, sigma_i = |A v_i|, sorted descending by a stable rank
    (NaN last), u_1 and u_2 = A v / sigma, u_3 = u_1 x u_2 turned to the
    side of A v_3. Returns (U, S, Vh) in float32, A's shapes.
    ops=torch.float64 leaves every operation in float64 instead (not the
    kernel's arithmetic)."""
    rn = _rounding(ops)
    shape = A.shape
    a = A.reshape(-1, 3, 3).float().double()
    B = _sum3(rn(a[:, :, :, None] * a[:, :, None, :]), 1, rn)  # [N, j, k]
    _, v = _jacobi(B, sweeps, rn, offs, done)
    av = _sum3(rn(a[:, :, :, None] * v[:, None, :, :]), 2, rn)  # [N, r, i]
    sig = rn(_sqrt(_sum3(rn(av * av), 1, rn)))                 # [N, i]
    key = torch.where(torch.isnan(sig), torch.full_like(sig, float("-inf")),
                      sig)
    order = torch.sort(key, dim=-1, descending=True, stable=True).indices
    S = sig.gather(-1, order)
    cols = order[:, None, :].expand_as(v)
    Vh = v.gather(-1, cols).transpose(-1, -2)
    avs = av.gather(-1, cols)
    d = torch.where(S > 0, S, torch.ones_like(S))
    u1 = rn(avs[:, :, 0] / d[:, :1])
    u2 = rn(avs[:, :, 1] / d[:, 1:2])

    def cross(i, j):
        return rn(rn(u1[:, i] * u2[:, j]) - rn(u1[:, j] * u2[:, i]))

    u3 = torch.stack([cross(1, 2), cross(2, 0), cross(0, 1)], -1)
    dot = _sum3(rn(u3 * avs[:, :, 2]), 1, rn)
    u3 = torch.where((dot < 0)[:, None], -u3, u3)
    U = torch.stack([u1, u2, u3], -1)
    return (U.float().reshape(shape), S.float().reshape(shape[:-1]),
            Vh.float().reshape(shape))


# ---------------------------------------------------------------------
# comparing two solvers
# ---------------------------------------------------------------------


def _clusters(lam: np.ndarray, scale: float) -> list:
    """[(start, stop, relative gap)] of the ascending values lam: neighbours
    closer than GAP_MIN x scale join one cluster; the gap is the cluster's
    distance to its nearest neighbour outside it, over scale (a cluster
    holding every value has none and is left out)."""
    cuts = [0] + [k + 1 for k in range(len(lam) - 1)
                  if lam[k + 1] - lam[k] >= GAP_MIN * scale] + [len(lam)]
    out = []
    for i0, i1 in zip(cuts[:-1], cuts[1:]):
        seps = ([lam[i0] - lam[i0 - 1]] if i0 > 0 else []) + (
            [lam[i1] - lam[i1 - 1]] if i1 < len(lam) else [])
        if seps:
            out.append((i0, i1, min(seps) / scale))
    return out


def _projector_scores(Va, Vb, lam, scale) -> list:
    """|P_a - P_b| (spectral norm) x gap / eps32 of every cluster of one
    matrix's vectors (columns, in lam's order)."""
    out = []
    for i0, i1, gap in _clusters(lam, scale):
        Pa = Va[:, i0:i1] @ Va[:, i0:i1].T
        Pb = Vb[:, i0:i1] @ Vb[:, i0:i1].T
        out.append(np.linalg.norm(Pa - Pb, 2) * gap / EPS32)
    return out


def compare_eigh(wa, Va, wb, Vb) -> dict:
    """Two solvers' eigendecompositions of the same matrices [B, n, n]
    (w ascending, vectors as columns; any arrays): the largest eigenvalue
    difference over max |lambda| (bound EIG_TOL), and over the clusters of
    eigenvalues (b's, in float64) the number compared and the worst
    projector difference x gap / eps32 (bound VEC_TOL)."""
    n = np.shape(Vb)[-1]
    wa, wb = (np.asarray(x, np.float64).reshape(-1, n) for x in (wa, wb))
    Va, Vb = (np.asarray(x, np.float64).reshape(-1, n, n) for x in (Va, Vb))
    scale = np.maximum(np.abs(wb).max(-1), 1e-300)
    val = float((np.abs(wa - wb).max(-1) / scale).max(initial=0.0))
    scores = [s for k in range(len(wb))
              for s in _projector_scores(Va[k], Vb[k], wb[k], scale[k])]
    return dict(val_err=val, val_tol=EIG_TOL, compared=len(scores),
                worst=float(max(scores, default=0.0)), bound=VEC_TOL)


def compare_svd3(Ua, Sa, Vha, Ub, Sb, Vhb) -> dict:
    """Two solvers' SVDs of the same 3x3 matrices: the largest singular
    value difference over sigma_1 (bound EIG_TOL), and over the clusters of
    singular values (b's, ascending order) the worst projector difference of
    the left and of the right vectors x gap / eps32 (bound VEC_TOL)."""
    Sa, Sb = (np.asarray(x, np.float64).reshape(-1, 3) for x in (Sa, Sb))
    Ua, Ub, Va, Vb = (np.asarray(x, np.float64).reshape(-1, 3, 3)
                      for x in (Ua, Ub, Vha, Vhb))
    Va, Vb = Va.transpose(0, 2, 1), Vb.transpose(0, 2, 1)
    scale = np.maximum(Sb[:, 0], 1e-300)
    val = float((np.abs(Sa - Sb).max(-1) / scale).max(initial=0.0))
    scores = []
    for k in range(len(Sb)):
        lam = Sb[k, ::-1]                                  # ascending
        for X, Y in ((Ua[k], Ub[k]), (Va[k], Vb[k])):
            scores += _projector_scores(X[:, ::-1], Y[:, ::-1], lam,
                                        scale[k])
    return dict(val_err=val, val_tol=EIG_TOL, compared=len(scores),
                worst=float(max(scores, default=0.0)), bound=VEC_TOL)


# ---------------------------------------------------------------------
# the kernels' wrappers
# ---------------------------------------------------------------------


def _device_of(name: str, x: torch.Tensor) -> bool:
    """True for a CPU tensor (the plain version runs), False for a CUDA
    one (the kernel runs); raises for anything else."""
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return False


def sym_eigh(M: torch.Tensor):
    """Eigendecomposition of symmetric matrices M [..., n, n], n <= 10:
    (w [..., n] ascending, V [..., n, n] eigenvectors as columns). Same
    contract as `sym_eigh_ref`."""
    if _device_of("sym_eigh", M):
        return sym_eigh_ref(M)
    n = M.shape[-1]
    if (M.dtype != torch.float32 or M.ndim < 2 or M.shape[-2] != n
            or not 1 <= n <= MAX_N):
        raise ValueError(f"sym_eigh: expects float32 [..., n, n] with n <= "
                         f"{MAX_N}, got {M.dtype} {tuple(M.shape)}")
    M = M.contiguous()
    dev = M.device
    w = torch.empty(M.shape[:-1], dtype=torch.float32, device=dev)
    V = torch.empty(M.shape, dtype=torch.float32, device=dev)
    batch = M.numel() // (n * n)
    if batch == 0:
        return w, V
    with build.on_device(dev):
        rc = _lib().sym_eigh(M.data_ptr(), w.data_ptr(), V.data_ptr(), batch,
                             n, EIGH_SWEEPS, build.stream_handle(dev))
    build.check_launch(rc, "sym_eigh")
    sym_eigh.launches += 1
    return w, V


def svd3(A: torch.Tensor):
    """SVD of 3x3 matrices A [..., 3, 3]: (U, S [..., 3] descending, Vh)
    with A = U diag(S) Vh. Same contract as `svd3_ref`, with U[..., 2] the
    cross product of the first two left vectors, on the side of A v_3."""
    if _device_of("svd3", A):
        return svd3_ref(A)
    if A.dtype != torch.float32 or A.ndim < 2 or A.shape[-2:] != (3, 3):
        raise ValueError(f"svd3: expects float32 [..., 3, 3], got "
                         f"{A.dtype} {tuple(A.shape)}")
    A = A.contiguous()
    dev = A.device
    U = torch.empty(A.shape, dtype=torch.float32, device=dev)
    S = torch.empty(A.shape[:-1], dtype=torch.float32, device=dev)
    Vh = torch.empty(A.shape, dtype=torch.float32, device=dev)
    batch = A.numel() // 9
    if batch == 0:
        return U, S, Vh
    with build.on_device(dev):
        rc = _lib().svd3(A.data_ptr(), U.data_ptr(), S.data_ptr(),
                         Vh.data_ptr(), batch, SVD_SWEEPS,
                         build.stream_handle(dev))
    build.check_launch(rc, "svd3")
    svd3.launches += 1
    return U, S, Vh


sym_eigh.launches = 0
svd3.launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    lib = build.load_library("small_linalg")
    lib.sym_eigh.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.sym_eigh.restype = ctypes.c_int
    lib.svd3.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.svd3.restype = ctypes.c_int
    return lib

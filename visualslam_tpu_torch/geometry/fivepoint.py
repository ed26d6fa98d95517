"""Minimal 5-point essential-matrix solver (visualslam_tpu/geometry/
fivepoint.py), batched over hypotheses: the hidden-variable resultant
method with fixed shapes.

  1. nullspace basis E = x E1 + y E2 + z E3 + E4 from eigh(A^T A) (9x9);
  2. the 10 cubic constraints (det E = 0, 2 E E^T E - tr(E E^T) E = 0) in
     coefficient form: evaluated at 20 fixed sample points, times a
     precomputed inverse monomial Vandermonde;
  3. hidden variable z: the 20 monomials grouped by their (x, y) part into
     a 10x10 polynomial matrix M(z) of z-degree <= 3;
  4. det M(z), of degree 10, from 10x10 determinants at 11 fixed z nodes
     through a precomputed inverse Vandermonde;
  5. real roots by a sign-change grid in theta = atan(z) and 40 bisection
     steps;
  6. per root, (x, y) from the eigh-smallest eigenvector of M(z)^T M(z),
     polished by 3 Gauss-Newton steps on the 10 constraint values.

The constants are the JAX package's float64 numpy ones (copied, same
seed), used in float32 and built once per device (`_const`; never inside a
capture, where a copy from host memory would raise or bake a pointer into
the graph). The Gauss-Newton Jacobian is the constraints'
analytic derivative (the JAX package takes `jacfwd` of them): E is linear
in (x, y, z), so dE/dv_i = E_i, d det E = <cof(E), dE> and
dF = 2 (dE E^T E + E dE^T E + E E^T dE) - 2 <E, dE> E - tr(E E^T) dE.
3x3 determinants and solves are closed-form; the 9x9 and 10x10
eigendecompositions are `kernels.sym_eigh` (the Jacobi kernel on the card,
no host sync; ops.cuda.PLAIN: torch.linalg.eigh) and the 10x10
determinants torch.linalg.det (on the card an LU with no host read, which
captures). A degenerate eigenspace has no preferred basis: two
eigensolvers give different nullspace bases and so candidates in another
order; compare candidate sets, never slot by slot.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from visualslam_tpu_torch.ops.cuda import KERNELS, Kernels
from visualslam_tpu_torch.utils.masked import top_k

# 20 cubic monomials in (x, y, z), grouped by (x, y) part; XY_GROUPS order
# is M(z)'s column order
_EXPS = [
    (3, 0, 0), (0, 3, 0), (2, 1, 0), (1, 2, 0),
    (2, 0, 1), (2, 0, 0), (0, 2, 1), (0, 2, 0),
    (1, 1, 1), (1, 1, 0), (1, 0, 2), (1, 0, 1), (1, 0, 0),
    (0, 1, 2), (0, 1, 1), (0, 1, 0),
    (0, 0, 3), (0, 0, 2), (0, 0, 1), (0, 0, 0),
]
_XY_GROUPS = [(3, 0), (0, 3), (2, 1), (1, 2), (2, 0), (0, 2), (1, 1),
              (1, 0), (0, 1), (0, 0)]
_COL_OF = {g: i for i, g in enumerate(_XY_GROUPS)}

# sample points for coefficient extraction: fixed pseudo-random, unit scale
_SAMPLES = np.random.default_rng(12345).uniform(-1.0, 1.0, (20, 3))
_V = np.stack([[x ** a * y ** b * z ** c for (a, b, c) in _EXPS]
               for x, y, z in _SAMPLES])           # [20 samples, 20 mons]
_VINV = np.linalg.inv(_V)
# one-hot scatter [20 mons, 4 z-degrees, 10 cols]
_SCATTER = np.zeros((20, 4, 10))
for _k, (_a, _b, _c) in enumerate(_EXPS):
    _SCATTER[_k, _c, _COL_OF[(_a, _b)]] = 1.0
# z nodes for the det interpolation: 11 Chebyshev nodes x 2
_ZN = 2.0 * np.cos((2 * np.arange(11) + 1) / 22.0 * np.pi)
_ZVINV = np.linalg.inv(np.stack([_ZN ** k for k in range(11)], axis=1))
_N_GRID = 256
_THETA = np.linspace(-np.pi / 2 + 1e-3, np.pi / 2 - 1e-3, _N_GRID)

MAX_CANDIDATES = 10
_BISECT = 40
_GN_STEPS = 3


_CONSTANTS = {"samples": _SAMPLES, "vinv": _VINV,
              "scatter": _SCATTER.reshape(20, 40), "zn": _ZN,
              "zvinv": _ZVINV, "theta": _THETA}


@functools.lru_cache(maxsize=None)
def _const(name: str, device: torch.device) -> torch.Tensor:
    """_CONSTANTS[name] in float32 on device, built on first use there
    (outside any capture: the warm-up of a captured program makes it)."""
    return torch.as_tensor(np.asarray(_CONSTANTS[name], np.float32),
                           device=device)


def _det3(M: torch.Tensor) -> torch.Tensor:
    """Determinants of [..., 3, 3] by cofactor expansion along row 0."""
    return (M[..., 0, 0] * (M[..., 1, 1] * M[..., 2, 2]
                            - M[..., 1, 2] * M[..., 2, 1])
            - M[..., 0, 1] * (M[..., 1, 0] * M[..., 2, 2]
                              - M[..., 1, 2] * M[..., 2, 0])
            + M[..., 0, 2] * (M[..., 1, 0] * M[..., 2, 1]
                              - M[..., 1, 1] * M[..., 2, 0]))


def _cof3(M: torch.Tensor) -> torch.Tensor:
    """Cofactor matrices of [..., 3, 3]: d det M / dM."""
    rows = []
    for i in range(3):
        i1, i2 = (i + 1) % 3, (i + 2) % 3
        row = []
        for j in range(3):
            j1, j2 = (j + 1) % 3, (j + 2) % 3
            row.append(M[..., i1, j1] * M[..., i2, j2]
                       - M[..., i1, j2] * M[..., i2, j1])
        rows.append(torch.stack(row, dim=-1))
    return torch.stack(rows, dim=-2)


def _combine(Eb: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """E = x E1 + y E2 + z E3 + E4. Eb [N, 4, 3, 3]; xyz [N, S, 3] ->
    [N, S, 3, 3]."""
    w = xyz[..., :, None, None]
    return (w[:, :, 0] * Eb[:, None, 0] + w[:, :, 1] * Eb[:, None, 1]
            + w[:, :, 2] * Eb[:, None, 2] + Eb[:, None, 3])


def _trace_constraint(E: torch.Tensor) -> torch.Tensor:
    EEt = E @ E.transpose(-1, -2)
    tr = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)
    return 2.0 * (EEt @ E) - tr[..., None, None] * E


def constraint_values(Eb: torch.Tensor, xyz: torch.Tensor) -> torch.Tensor:
    """The 10 cubic constraint values at points xyz [N, S, 3] ->
    [N, S, 10] (det E first, then the 9 trace-constraint entries)."""
    E = _combine(Eb, xyz)
    return torch.cat([_det3(E)[..., None],
                      _trace_constraint(E).flatten(-2)], dim=-1)


def _constraint_jacobian(Eb: torch.Tensor, xyz: torch.Tensor):
    """(values [N, S, 10], Jacobian [N, S, 10, 3]) of the constraints."""
    E = _combine(Eb, xyz)                                  # [N, S, 3, 3]
    Et = E.transpose(-1, -2)
    EEt = E @ Et
    tr = EEt.diagonal(dim1=-2, dim2=-1).sum(-1)[..., None, None]
    F = 2.0 * (EEt @ E) - tr * E
    cof = _cof3(E)
    cols = []
    for i in range(3):
        dE = Eb[:, None, i]                                # [N, 1, 3, 3]
        ddet = (cof * dE).sum(dim=(-2, -1))
        dtr = 2.0 * (E * dE).sum(dim=(-2, -1))[..., None, None]
        dF = (2.0 * (dE @ Et @ E + E @ dE.transpose(-1, -2) @ E + EEt @ dE)
              - dtr * E - tr * dE)
        cols.append(torch.cat([ddet[..., None], dF.flatten(-2)], dim=-1))
    vals = torch.cat([_det3(E)[..., None], F.flatten(-2)], dim=-1)
    return vals, torch.stack(cols, dim=-1)


def _solve3(H: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """H^-1 g for [..., 3, 3] and [..., 3] (Cramer's rule)."""
    det = _det3(H)
    cof = _cof3(H)                                         # symmetric H
    return (cof.transpose(-1, -2) @ g[..., None])[..., 0] / det[..., None]


def _poly_eval_trig(c: torch.Tensor, th: torch.Tensor) -> torch.Tensor:
    """sum_k c_k sin^k cos^(10-k) at theta: the det polynomial at
    z = tan(theta), scaled by cos^10. c [N, 11]; th [N, G] or [G]."""
    s, co = torch.sin(th), torch.cos(th)
    powers = torch.stack([s ** k * co ** (10 - k) for k in range(11)], -1)
    if powers.ndim == 2:
        return c @ powers.T
    return (powers * c[:, None, :]).sum(-1)


def _real_roots_deg10(c: torch.Tensor):
    """Real roots of sum c_k z^k per row of c [N, 11] by sign-change
    bisection in theta = atan(z): (roots [N, 10], valid [N, 10])."""
    c = c / c.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    theta = _const("theta", c.device)
    vals = _poly_eval_trig(c, theta)                       # [N, G]
    sc = vals[:, :-1] * vals[:, 1:] < 0                    # brackets
    grid = torch.arange(_N_GRID - 1, dtype=torch.float32, device=c.device)
    score = torch.where(sc, grid, torch.full_like(grid, float("-inf")))
    _, idx = top_k(score, MAX_CANDIDATES)
    valid = sc.gather(1, idx)
    lo = theta[idx]
    hi = theta[(idx + 1).clamp(max=_N_GRID - 1)]
    flo = _poly_eval_trig(c, lo)
    for _ in range(_BISECT):
        mid = 0.5 * (lo + hi)
        fm = _poly_eval_trig(c, mid)
        left = flo * fm > 0
        lo, hi, flo = (torch.where(left, mid, lo), torch.where(left, hi, mid),
                       torch.where(left, fm, flo))
    return torch.tan(0.5 * (lo + hi)), valid


def five_point(x1: torch.Tensor, x2: torch.Tensor,
               kernels: Kernels = KERNELS):
    """Essential matrices from 5 normalised correspondences per hypothesis.

    x1, x2: [N, 5, 2] (or [5, 2]). Returns (E [N, 10, 3, 3] unit-norm
    candidates, valid [N, 10]); invalid slots hold garbage matrices the
    caller masks with `valid`. Convention: x2^T E x1 = 0. The 9x9 and the
    N x 10 10x10 eigendecompositions are `kernels.sym_eigh`."""
    single = x1.ndim == 2
    if single:
        x1, x2 = x1[None], x2[None]
    dev = x1.device
    N = x1.shape[0]
    u1, v1 = x1[..., 0], x1[..., 1]
    u2, v2 = x2[..., 0], x2[..., 1]
    A = torch.stack([u2 * u1, u2 * v1, u2, v2 * u1, v2 * v1, v2,
                     u1, v1, torch.ones_like(u1)], dim=-1)  # [N, 5, 9]
    _, vecs = kernels.sym_eigh(A.transpose(-1, -2) @ A)
    Eb = vecs[..., :4].transpose(-1, -2).reshape(N, 4, 3, 3)

    P = constraint_values(Eb, _const("samples", dev).expand(N, 20, 3))
    C = (_const("vinv", dev) @ P).transpose(-1, -2)        # [N, 10, 20]
    # each constraint polynomial to unit coefficient norm
    C = C / torch.linalg.vector_norm(C, dim=-1, keepdim=True).clamp_min(1e-30)
    Mz = (C @ _const("scatter", dev)).reshape(N, 10, 4, 10)
    Mz = Mz.permute(0, 2, 1, 3)                            # [N, zdeg, 10, 10]

    def m_of(z):                                           # z [N, Z]
        z = z[..., None, None]
        return (Mz[:, None, 0] + z * Mz[:, None, 1] + (z * z) * Mz[:, None, 2]
                + (z ** 3) * Mz[:, None, 3])               # [N, Z, 10, 10]

    dets = torch.linalg.det(m_of(_const("zn", dev).expand(N, 11)))
    dets = dets / dets.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30)
    coef = dets @ _const("zvinv", dev).T                   # c_0..c_10
    roots, valid = _real_roots_deg10(coef)

    M = m_of(roots)                                        # [N, 10, 10, 10]
    _, vv = kernels.sym_eigh(M.transpose(-1, -2) @ M)
    m = vv[..., 0]                                         # xy-monomials
    denom = m[..., 9]
    tiny = torch.where(denom < 0, -1e-12, 1e-12)
    denom = torch.where(denom.abs() < 1e-12, tiny, denom)
    xyz = torch.stack([m[..., 7] / denom, m[..., 8] / denom, roots], dim=-1)

    # Gauss-Newton polish of (x, y, z) on the 10 constraint values
    eye = 1e-10 * torch.eye(3, device=dev)
    for _ in range(_GN_STEPS):
        r, J = _constraint_jacobian(Eb, xyz)
        Jt = J.transpose(-1, -2)
        xyz = xyz - _solve3(Jt @ J + eye, (Jt @ r[..., None])[..., 0])
    E = _combine(Eb, xyz)
    E = E / torch.linalg.vector_norm(E, dim=(-2, -1),
                                     keepdim=True).clamp_min(1e-12)
    return (E[0], valid[0]) if single else (E, valid)

"""The KITTI-scale global BA problem under variants of the two-view init's
arithmetic, solved by each BA solver and by the float64 LM:

    python -m visualslam_tpu_torch.init_variants --out DIR \
        [--variants kernels f32 f32_svd64 plain] [--seeds 0]

The two-view init decides the map, and so the problem that the
full-sequence global BA solves. chip_smoke.py's full_sequence phase holds
the schur_cg and schur_mf final costs on that problem within
KS_SOLVER_RTOL of the same LM run in float64 with the dense solve. This
script runs the port's KITTI-scale protocol (kitti_scale.run) once per
variant of the init's small solvers and RANSAC seed, rebuilds the
problem after the global BA as that phase does, solves it there with
schur_dense, schur_cg and schur_mf at the run configuration and with the
float64 dense LM, prints one JSON line per run, and saves the problem,
its configuration and the costs as DIR/<variant>_seed<k>.npz.
tests/jax_init_variants.py solves the saved problems with the JAX
package's solvers on the CPU.

The variants (ops/cuda/small_linalg.py):

  kernels    the shipped kernels: sym_eigh in float64 operations, svd3 in
             float32 (ops.cuda.KERNELS)
  f32        sym_eigh with every operation in float32 (the replay with
             ops=float32, on the card), svd3 the kernel
  f32_svd64  sym_eigh as f32, svd3 in float64 operations (the replay)
  plain      torch.linalg's eigh and svd (cuSOLVER; the init runs eagerly)

The replays are torch operations on the card's tensors, captured in the
init's graph as the kernels are. The seed is RansacConfig.seed, from which
the tracker draws its inits' RANSAC seeds.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time

import numpy as np
import torch

from visualslam_tpu_torch import kitti_scale
from visualslam_tpu_torch.ops.cuda import KERNELS, PLAIN
from visualslam_tpu_torch.ops.cuda import small_linalg as sl
from visualslam_tpu_torch.utils.card import require_device

SOLVERS = ("schur_dense", "schur_cg", "schur_mf")


def _f32_eigh(M):
    return sl.sym_eigh_jacobi(M, ops=torch.float32)


def _f64_svd(A):
    return sl.svd3_jacobi(A, ops=torch.float64)


VARIANTS = {
    "kernels": KERNELS,
    "f32": KERNELS._replace(sym_eigh=_f32_eigh),
    "f32_svd64": KERNELS._replace(sym_eigh=_f32_eigh, svd3=_f64_svd),
    "plain": KERNELS._replace(sym_eigh=PLAIN.sym_eigh, svd3=PLAIN.svd3),
}


def solve(p, cfg) -> dict:
    """Final costs of p under each solver at cfg (float32) and of the
    float64 dense LM, and each float32 cost's distance to it relative to
    it."""
    from visualslam_tpu_torch.backend.ba import run_ba

    p64 = p._replace(R=p.R.double(), t=p.t.double(), X=p.X.double(),
                     uv=p.uv.double())
    r64 = run_ba(p64, cfg.replace(solver="schur_dense"))
    c64 = float(r64.cost)
    costs = {s: float(run_ba(p, cfg.replace(solver=s)).cost)
             for s in SOLVERS}
    return dict(initial_cost=float(r64.initial_cost), f64_dense=c64,
                costs=costs,
                rel={s: abs(c - c64) / c64 for s, c in costs.items()})


def save(path: str, p, cfg, meta: dict) -> None:
    """The problem's fields, the BA configuration and `meta` (JSON) as an
    npz."""
    np.savez_compressed(
        path, **{k: v.detach().cpu().numpy() for k, v in p._asdict().items()},
        ba_cfg=json.dumps(dataclasses.asdict(cfg)), meta=json.dumps(meta))


def main(argv=None) -> None:
    from visualslam_tpu_torch.slam.global_ba import (
        build_global_problem,
        global_run_cfg,
    )

    ap = argparse.ArgumentParser(prog="visualslam_tpu_torch.init_variants")
    ap.add_argument("--out", required=True, help="directory for the npz")
    ap.add_argument("--variants", nargs="+", default=["kernels", "f32"],
                    choices=sorted(VARIANTS))
    ap.add_argument("--seeds", nargs="+", type=int, default=[0])
    ap.add_argument("--frames", type=int, default=kitti_scale.FRAMES)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = require_device(args.device, "init_variants")
    os.makedirs(args.out, exist_ok=True)
    rendered = kitti_scale.render(args.frames)
    for seed in args.seeds:
        cfg = kitti_scale.CONFIG.replace(
            ransac=kitti_scale.CONFIG.ransac.replace(seed=seed))
        for name in args.variants:
            t0 = time.perf_counter()
            out, tracker = kitti_scale.run(*rendered, device=dev, cfg=cfg,
                                           kernels=VARIANTS[name])
            p, _ = build_global_problem(tracker.map, device=dev)
            run_cfg = global_run_cfg(cfg.ba, p)
            meta = dict(variant=name, seed=seed,
                        keyframes=out["keyframes"],
                        loop_closures=out["loop_closures"],
                        ate_tracked_m=out["ate_tracked_m"],
                        ate_after_gba_m=out["ate_after_gba_m"],
                        shapes=dict(C=int(p.R.shape[0]), L=int(p.X.shape[0]),
                                    O=int(p.uv.shape[0])),
                        **solve(p, run_cfg))
            save(os.path.join(args.out, f"{name}_seed{seed}.npz"), p,
                 run_cfg, meta)
            meta["wall_s"] = round(time.perf_counter() - t0, 1)
            print(json.dumps(meta), flush=True)
            del tracker
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()

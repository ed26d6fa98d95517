"""The JAX package's BA solvers, and the port's on the CPU, on the global BA
problems that `python -m visualslam_tpu_torch.init_variants` saved on the
card:

    export JAX_PLATFORMS=cpu PYTHONPATH=.
    python tests/jax_init_variants.py DIR/*.npz

Each npz holds one KITTI-scale global BA problem (after the global BA, as
chip_smoke.py's full_sequence phase rebuilds it), its BA configuration and
the card's final costs. For each problem this prints one JSON line: the
final cost of the JAX package's run_ba under schur_dense, schur_cg and
schur_mf (float32, as the JAX package runs them) and of its dense LM in
float64, the port's run_ba on the CPU under the same solvers and its
float64 dense LM, and each float32 cost's distance to each float64 cost
relative to it: what chip_smoke.py's KS_SOLVER_RTOL gate holds the
port's card run to, asked of the JAX package on the same problem.

--orders N also solves N random permutations of each problem's
observations (seeds 0..N-1: the same problem, its float32 sums in
another order) with the float32 schur_cg and schur_mf of both packages,
and prints the distance of each run's final cost to the float64 LM's,
relative to it, per solver and package: how far the float32 LM's outcome
moves with the order of its sums (ROADMAP hazard 7).
"""

import argparse
import json

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from visualslam_tpu.backend import ba as jba  # noqa: E402
from visualslam_tpu.utils.config import BAConfig as JBAConfig  # noqa: E402
from visualslam_tpu_torch.backend import ba as tba  # noqa: E402
from visualslam_tpu_torch.utils.config import BAConfig  # noqa: E402
from visualslam_tpu_torch.utils.convert import from_numpy  # noqa: E402

SOLVERS = ("schur_dense", "schur_cg", "schur_mf")
FLOATS = ("R", "t", "X", "uv")


def load(path: str):
    """(the problem's arrays by field, the BA configuration's dict, the
    card run's record)."""
    z = np.load(path)
    arrays = {k: z[k] for k in tba.BAProblem._fields}
    return arrays, json.loads(str(z["ba_cfg"])), json.loads(str(z["meta"]))


def _as(arrays: dict, dtype) -> dict:
    return {k: (v.astype(dtype) if k in FLOATS else v)
            for k, v in arrays.items()}


def permuted(arrays: dict, seed: int) -> dict:
    """The problem with its observations in a random order."""
    perm = np.random.default_rng(seed).permutation(len(arrays["uv"]))
    return {k: (v[perm] if k in ("cam_idx", "lm_idx", "uv", "obs_valid")
                else v) for k, v in arrays.items()}


def jax_costs(arrays: dict, cfg: dict, solvers=SOLVERS,
              f64: bool = True) -> dict:
    run = jax.jit(jba.run_ba, static_argnums=1)
    jcfg = JBAConfig.from_dict(cfg)
    out = {}
    for s in solvers:
        p = jba.BAProblem(**{k: jnp.asarray(v) for k, v in
                             _as(arrays, np.float32).items()})
        out[s] = float(run(p, jcfg.replace(solver=s)).cost)
    if not f64:
        return out
    p64 = jba.BAProblem(**{k: jnp.asarray(v) for k, v in
                           _as(arrays, np.float64).items()})
    r64 = run(p64, jcfg.replace(solver="schur_dense"))
    assert r64.cost.dtype == jnp.float64
    out["f64_dense"] = float(r64.cost)
    return out


def port_costs(arrays: dict, cfg: dict, solvers=SOLVERS,
               f64: bool = True) -> dict:
    tcfg = BAConfig.from_dict(cfg)
    out = {}
    for s in solvers:
        p = from_numpy(tba.BAProblem, _as(arrays, np.float32), device="cpu")
        out[s] = float(tba.run_ba(p, tcfg.replace(solver=s)).cost)
    if not f64:
        return out
    p64 = from_numpy(tba.BAProblem, _as(arrays, np.float64), device="cpu")
    out["f64_dense"] = float(tba.run_ba(
        p64, tcfg.replace(solver="schur_dense")).cost)
    return out


def _rel(costs: dict, ref: float, solvers=SOLVERS) -> dict:
    return {s: abs(costs[s] - ref) / ref for s in solvers}


def orders(arrays: dict, cfg: dict, n: int, ref: float) -> dict:
    """{package: {solver: [relative distance to ref per order]}}."""
    cg = ("schur_cg", "schur_mf")
    out = {"jax": {s: [] for s in cg}, "port_cpu": {s: [] for s in cg}}
    for seed in range(n):
        a = permuted(arrays, seed)
        for name, fn in (("jax", jax_costs), ("port_cpu", port_costs)):
            for s, r in _rel(fn(a, cfg, cg, False), ref, cg).items():
                out[name][s].append(r)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("npz", nargs="+")
    ap.add_argument("--orders", type=int, default=0)
    args = ap.parse_args(argv)
    torch.set_num_threads(4)
    for path in args.npz:
        arrays, cfg, card = load(path)
        jx, pt = jax_costs(arrays, cfg), port_costs(arrays, cfg)
        print(json.dumps(dict(
            problem=path, variant=card["variant"], seed=card["seed"],
            shapes=card["shapes"], card=dict(f64_dense=card["f64_dense"],
                                             rel=card["rel"]),
            jax=dict(costs=jx, rel_to_jax_f64=_rel(jx, jx["f64_dense"]),
                     rel_to_port_f64=_rel(jx, pt["f64_dense"])),
            port_cpu=dict(costs=pt,
                          rel_to_port_f64=_rel(pt, pt["f64_dense"])))),
            flush=True)
        if args.orders:
            print(json.dumps(dict(problem=path, orders=args.orders,
                                  rel_to_f64=orders(arrays, cfg, args.orders,
                                                    pt["f64_dense"]))),
                  flush=True)


if __name__ == "__main__":
    main()

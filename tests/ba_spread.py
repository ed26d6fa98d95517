"""Run-to-run spread of the float32 BA solvers on one saved problem
(ROADMAP C.2), and the BA / sequence timings of one tree.

    python tests/ba_spread.py card PROBLEM.npz OUT.json [--reps 100]
    JAX_PLATFORMS=cpu PYTHONPATH=. python tests/ba_spread.py jax \\
        PROBLEM.npz OUT.json [--orders 32]
    PYTHONPATH=<tree> python tests/ba_spread.py measure PROBLEM.npz LABEL
    python tests/ba_spread.py summary OUT.json [--tail 1e-3]

PROBLEM.npz holds a BAProblem's nine fields (R, t, X, cam_idx, lm_idx,
uv, obs_valid, cam_valid, lm_valid) as numpy arrays, for example the
KITTI-scale run's rebuilt global-BA problem (`build_global_problem` after
`kitti_scale.run`).

`card`: the port's solvers on the card, each `--reps` times in the default
mode and as many times under `torch.use_deterministic_algorithms(True,
warn_only=True)`, through a copy of `run_ba`'s LM loop with the same
arithmetic that records, per run: the final cost, relative to the same
loop in float64 with the dense solve, the accept flag and lambda after
each LM iteration, the proposed cost, and over each CG solve's live
iterations the smallest p.Ap, the smallest p.Ap / p.p and the first
iteration with p.Ap <= 0. Imports no JAX.

`jax`: the JAX package's float32 LM loop (ba_step, robust_cost and the
masked accept of `_run_ba_impl`) in the identity observation order and
`--orders` random permutations of the observation axis, schur_cg and
schur_mf, against its own float64 dense LM run (`jax.enable_x64`).

`measure`: the package first on PYTHONPATH, for running a parent and a
change in turns on one card: the warm global BA on the problem (schur_mf,
ms median of 5, device launches and busy ms from the profiler, host
syncs, segment-sum launches), the window BA on the engine's [Kl, W] =
[2048, 10] observation grid (schur_dense, ms median of 10, launches,
busy ms), sequence frames/s (bench protocol, median of 3) and whether the
three sequence runs' trajectories are equal; one line, "MEASURE {json}".

`summary`: reads a `card` or `jax` output and prints, per solver and
mode, the spread and where each run past the tail leaves the modal LM
path (see `summary`).
"""

from __future__ import annotations

import json
import sys
import time
import warnings

import numpy as np

FIELDS = ("R", "t", "X", "cam_idx", "lm_idx", "uv", "obs_valid",
          "cam_valid", "lm_valid")


def _arg(args, name, default):
    return type(default)(args[args.index(name) + 1]) if name in args \
        else default


def _patterns(runs) -> dict:
    pat: dict = {}
    for r in runs:
        k = "".join("1" if a else "0" for a in r["accept"])
        pat[k] = pat.get(k, 0) + 1
    return pat


def card(src: str, dst: str, reps: int) -> None:
    import torch

    import visualslam_tpu_torch.backend.ba as ba
    from visualslam_tpu_torch.utils.card import card_name
    from visualslam_tpu_torch.utils.config import FAST_CONFIG

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {card_name()}; package {ba.__file__}", flush=True)
    rec = []

    def cg_rec(matvec, b, precond, maxiter, tol=1e-10):
        """ba.cg's arithmetic, plus the smallest p.Ap (and p.Ap / p.p)
        over the live iterations and the first with p.Ap <= 0, kept on
        the device."""
        atol2 = tol * tol * (b * b).sum()
        x = torch.zeros_like(b)
        r = b - matvec(x)
        p = precond(r)
        gamma = (r * p).sum()
        inf = torch.full((), float("inf"), dtype=b.dtype, device=b.device)
        mn, mq = inf, inf
        first = torch.full((), -1, device=b.device)
        for k in range(maxiter):
            live = (r * r).sum() > atol2
            Ap = matvec(p)
            pAp = (p * Ap).sum()
            alpha = gamma / pAp
            mn = torch.where(live, torch.minimum(mn, pAp), mn)
            mq = torch.where(live, torch.minimum(mq, pAp / (p * p).sum()),
                             mq)
            first = torch.where(live & (pAp <= 0) & (first < 0),
                                torch.full_like(first, k), first)
            x_ = x + alpha * p
            r_ = r - alpha * Ap
            z_ = precond(r_)
            gamma_ = (r_ * z_).sum()
            p_ = z_ + (gamma_ / gamma) * p
            x = torch.where(live, x_, x)
            r = torch.where(live, r_, r)
            p = torch.where(live, p_, p)
            gamma = torch.where(live, gamma_, gamma)
        rec.append(torch.stack([mn.double(), mq.double(), first.double()]))
        return x

    ba.cg = cg_rec

    def run(p, cfg) -> dict:
        """run_ba's LM loop with the same arithmetic, recorded."""
        ba.f32_matmul()
        R, t, X = p.R, p.t, p.X
        lam = torch.full((), cfg.damping_init, dtype=X.dtype,
                         device=X.device)
        cost = ba.robust_cost(p, R, t, X, cfg.huber_delta)
        init = cost
        acc, lams, newc = [], [], []
        rec.clear()
        for _ in range(cfg.iters):
            Rn, tn, Xn = ba.ba_step(p, R, t, X, lam, cfg)
            new_cost = ba.robust_cost(p, Rn, tn, Xn, cfg.huber_delta)
            accept = new_cost < cost
            R = torch.where(accept, Rn, R)
            t = torch.where(accept, tn, t)
            X = torch.where(accept, Xn, X)
            cost = torch.where(accept, new_cost, cost)
            lam = torch.clamp(torch.where(accept, lam * cfg.damping_down,
                                          lam * cfg.damping_up), 1e-9, 1e6)
            acc.append(accept)
            lams.append(lam)
            newc.append(new_cost)
        out = dict(cost=float(cost), init=float(init),
                   accept=[bool(a) for a in torch.stack(acc).cpu()],
                   lam=torch.stack(lams).double().cpu().tolist(),
                   new_cost=torch.stack(newc).double().cpu().tolist())
        if rec:
            m = torch.stack(rec).cpu().numpy()
            out["min_pAp"] = m[:, 0].tolist()
            out["min_pAp_over_pp"] = m[:, 1].tolist()
            out["first_nonpos_cg_iter"] = m[:, 2].astype(int).tolist()
        return out

    z = np.load(src)
    p = ba.BAProblem(**{k: torch.as_tensor(z[k], device=dev)
                        for k in FIELDS})
    C, L, O = p.R.shape[0], p.X.shape[0], p.uv.shape[0]
    base = FAST_CONFIG.ba.replace(solver="schur_mf", max_cameras=C,
                                  max_landmarks=L, max_observations=O)
    p64 = p._replace(R=p.R.double(), t=p.t.double(), X=p.X.double(),
                     uv=p.uv.double())
    ref = run(p64, base.replace(solver="schur_dense"))
    c64 = ref["cost"]
    print(f"problem C={C} L={L} O={O}; float64 dense: {json.dumps(ref)}",
          flush=True)
    result = dict(C=C, L=L, O=O, f64_dense=ref, runs={})
    for det in (False, True):
        for solver in ("schur_cg", "schur_mf", "schur_dense"):
            cfg = base.replace(solver=solver)
            key = f"{solver}/{'deterministic' if det else 'default'}"
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                if det:
                    torch.use_deterministic_algorithms(True, warn_only=True)
                try:
                    plain = float(ba.run_ba(p, cfg).cost)
                    t0 = time.perf_counter()
                    runs = [run(p, cfg) for _ in range(reps)]
                    sec = time.perf_counter() - t0
                finally:
                    torch.use_deterministic_algorithms(False)
            rel = [abs(r["cost"] - c64) / c64 for r in runs]
            costs = [r["cost"] for r in runs]
            result["runs"][key] = dict(
                runs=runs, rel=rel, plain_run_ba_cost=plain,
                distinct_costs=len(set(costs)), seconds=sec,
                warnings=sorted({str(w.message)[:160] for w in caught}))
            print(f"{key}: rel min {min(rel):.3e} median "
                  f"{np.median(rel):.3e} max {max(rel):.3e}; > 1e-3: "
                  f"{sum(x > 1e-3 for x in rel)}, > 5e-3: "
                  f"{sum(x > 5e-3 for x in rel)}, > 1e-2: "
                  f"{sum(x > 1e-2 for x in rel)}; distinct costs "
                  f"{len(set(costs))}; accept patterns {_patterns(runs)}; "
                  f"run_ba itself {plain:.9e} (rel "
                  f"{abs(plain - c64) / c64:.3e}); {sec:.1f} s", flush=True)
    with open(dst, "w") as f:
        json.dump(result, f)


def jax_orders(src: str, dst: str, n_orders: int) -> None:
    import jax
    import jax.numpy as jnp

    from visualslam_tpu.backend import ba as jba
    from visualslam_tpu.utils.config import FAST_CONFIG

    z = np.load(src)
    arr = {k: z[k] for k in FIELDS}
    C, L, O = arr["R"].shape[0], arr["X"].shape[0], arr["uv"].shape[0]
    base = FAST_CONFIG.ba.replace(max_cameras=C, max_landmarks=L,
                                  max_observations=O)

    def lm_run(p, cfg):
        with jax.default_matmul_precision("float32"):
            lam = jnp.asarray(cfg.damping_init, p.X.dtype)
            cost = jba.robust_cost(p, p.R, p.t, p.X, cfg.huber_delta)

            def body(carry, _):
                R, t, X, lam, cost = carry
                Rn, tn, Xn = jba.ba_step(p, R, t, X, lam, cfg)
                new_cost = jba.robust_cost(p, Rn, tn, Xn, cfg.huber_delta)
                accept = new_cost < cost
                lam2 = jnp.clip(jnp.where(accept, lam * cfg.damping_down,
                                          lam * cfg.damping_up), 1e-9, 1e6)
                return (jnp.where(accept, Rn, R), jnp.where(accept, tn, t),
                        jnp.where(accept, Xn, X), lam2,
                        jnp.where(accept, new_cost, cost)), (accept, lam2,
                                                             new_cost)

            carry, rec = jax.lax.scan(body, (p.R, p.t, p.X, lam, cost),
                                      None, length=cfg.iters)
        return carry[4], rec

    def problem(order, dtype):
        a = dict(arr)
        for k in ("cam_idx", "lm_idx", "uv", "obs_valid"):
            a[k] = a[k][order]
        return jba.BAProblem(**{
            k: jnp.asarray(v.astype(dtype) if v.dtype.kind == "f" else v)
            for k, v in a.items()})

    def summary(cost, rec):
        acc, lam, newc = rec
        return dict(cost=float(cost),
                    accept=[bool(x) for x in np.asarray(acc)],
                    lam=np.asarray(lam, np.float64).tolist(),
                    new_cost=np.asarray(newc, np.float64).tolist())

    with jax.enable_x64(True):
        ref = summary(*jax.jit(lm_run, static_argnums=1)(
            problem(np.arange(O), np.float64),
            base.replace(solver="schur_dense")))
    c64 = ref["cost"]
    print(f"problem C={C} L={L} O={O}; float64 dense: {json.dumps(ref)}",
          flush=True)
    rng = np.random.default_rng(0)
    orders = [np.arange(O)] + [rng.permutation(O) for _ in range(n_orders)]
    out = dict(C=C, L=L, O=O, f64_dense=ref, runs={})
    for solver in ("schur_cg", "schur_mf"):
        f32 = jax.jit(lm_run, static_argnums=1)
        cfg = base.replace(solver=solver)
        t0 = time.perf_counter()
        runs = [summary(*f32(problem(o, np.float32), cfg)) for o in orders]
        rel = [abs(r["cost"] - c64) / c64 for r in runs]
        out["runs"][solver] = dict(runs=runs, rel=rel)
        print(f"{solver}: identity order rel {rel[0]:.3e}; over "
              f"{len(rel)} orders min {min(rel):.3e} median "
              f"{np.median(rel):.3e} max {max(rel):.3e}; > 1e-3: "
              f"{sum(x > 1e-3 for x in rel)}, > 5e-3: "
              f"{sum(x > 5e-3 for x in rel)}, > 1e-2: "
              f"{sum(x > 1e-2 for x in rel)}; accept patterns "
              f"{_patterns(runs)}; {time.perf_counter() - t0:.1f} s",
              flush=True)
    with open(dst, "w") as f:
        json.dump(out, f)


def measure(src: str, label: str) -> None:
    import torch

    from visualslam_tpu_torch import bench
    from visualslam_tpu_torch.backend import ba
    from visualslam_tpu_torch.ops.cuda import (
        KERNELS,
        launch_counts,
        reset_launch_counts,
    )
    from visualslam_tpu_torch.utils.card import card_name
    from visualslam_tpu_torch.utils.config import FAST_CONFIG

    dev = torch.device("cuda:0")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    def wall(fn, reps):
        fn()
        torch.cuda.synchronize()
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            ts.append(1e3 * (time.perf_counter() - t0))
        return float(np.median(ts)), ts

    def profile(fn):
        from torch.profiler import ProfilerActivity, profile as prof

        torch.cuda.synchronize()
        with prof(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as pr:
            fn()
            torch.cuda.synchronize()
        ev = [e for e in pr.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
        k = [e for e in ev if not e.name.startswith(("Memcpy", "Memset"))]
        sums = sum(e.time_range.elapsed_us() for e in k
                   if "segment_sum" in e.name or "indexFunc" in e.name)
        return (len(k), sum(e.time_range.elapsed_us() for e in ev) / 1e3,
                sums / 1e3)

    def syncs(fn):
        torch.cuda.synchronize()
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return sum("called a synchronizing" in str(w.message)
                   for w in caught)

    def counted(fn):
        reset_launch_counts()
        fn()
        torch.cuda.synchronize()
        return launch_counts().get("segment_sum")

    def grid_problem(W=10, Kl=2048, per=3, seed=5):
        """engine._window_ba's layout: observation o = k W + w on the
        [Kl, W] grid, landmark k seen by `per` consecutive cameras of a
        slow dolly, the rest of its row invalid."""
        r = np.random.default_rng(seed)
        a = 0.01 * np.arange(W)
        R = np.stack([[[np.cos(x), 0, np.sin(x)], [0, 1, 0],
                       [-np.sin(x), 0, np.cos(x)]] for x in a])
        cw = np.stack([0.05 * np.arange(W), np.zeros(W),
                       0.4 * np.arange(W)], -1)
        t = -np.einsum("cij,cj->ci", R, cw)
        X = np.stack([r.uniform(-15, 15, Kl), r.uniform(-6, 6, Kl),
                      r.uniform(10, 40, Kl)], -1)
        first = r.integers(0, W - per + 1, Kl)
        o = np.arange(Kl * W)
        cam, lm = o % W, o // W
        valid = (cam >= first[lm]) & (cam < first[lm] + per)
        Xc = np.einsum("oij,oj->oi", R[cam], X[lm]) + t[cam]
        uv = np.where(valid[:, None], Xc[:, :2] / Xc[:, 2:], 0.0)
        t = t + r.normal(0, 0.02, t.shape) * (np.arange(W) > 0)[:, None]

        def T(x, d=torch.float32):
            return torch.as_tensor(np.asarray(x), dtype=d, device=dev)

        return ba.BAProblem(
            R=T(R), t=T(t), X=T(X + r.normal(0, 0.05, X.shape)),
            cam_idx=T(cam, torch.int32), lm_idx=T(lm, torch.int32),
            uv=T(uv), obs_valid=T(valid, torch.bool),
            cam_valid=T(np.ones(W, bool), torch.bool),
            lm_valid=T(np.ones(Kl, bool), torch.bool))

    out = dict(label=label, card=card_name(), package=ba.__file__)
    z = np.load(src)
    p = ba.BAProblem(**{k: torch.as_tensor(z[k], device=dev)
                        for k in FIELDS})
    cfg = FAST_CONFIG.ba.replace(solver="schur_mf",
                                 max_cameras=p.R.shape[0],
                                 max_landmarks=p.X.shape[0],
                                 max_observations=p.uv.shape[0])
    gba = lambda: ba.run_ba(p, cfg)          # noqa: E731
    out["global_ba_ms"], out["global_ba_ms_all"] = wall(gba, 5)
    (out["global_ba_launches"], out["global_ba_busy_ms"],
     out["global_ba_sum_ms"]) = profile(gba)
    out["global_ba_syncs"] = syncs(gba)
    out["global_ba_segment_sum_launches"] = counted(gba)
    out["global_ba_cost"] = [float(gba().cost) for _ in range(3)]
    gp = grid_problem()
    wcfg = FAST_CONFIG.ba.replace(solver="schur_dense", max_cameras=10)
    wba = lambda: ba.run_ba(gp, wcfg)        # noqa: E731
    out["window_ba_ms"], out["window_ba_ms_all"] = wall(wba, 10)
    (out["window_ba_launches"], out["window_ba_busy_ms"],
     out["window_ba_sum_ms"]) = profile(wba)
    out["window_ba_cost"] = [float(wba().cost) for _ in range(3)]
    frames, seq = bench.render_sequence(bench.SEQ_FRAMES + bench.INIT_FRAMES)
    bench.warmup(FAST_CONFIG, dev, KERNELS)
    fps, trajs = [], []
    for _ in range(3):
        tracker, seconds = bench.run_once(frames, seq.intrinsics,
                                          FAST_CONFIG, dev, KERNELS)
        fps.append(bench.SEQ_FRAMES / seconds)
        trajs.append(tracker.trajectory())
    out["sequence_fps"] = float(np.median(fps))
    out["sequence_fps_runs"] = fps
    out["sequence_trajectories_equal"] = [
        bool(np.array_equal(trajs[0], t)) for t in trajs[1:]]
    print("MEASURE " + json.dumps(out), flush=True)


def summary(src: str, tail: float) -> None:
    """Per solver and mode of a `card` or `jax` output: the spread of the
    final cost relative to the float64 dense run, the modal accept
    pattern, and for every run past `tail`: its accept pattern, the first
    LM iteration where it leaves the modal pattern, lambda before that
    iteration, its proposed cost there against the bulk's median, and (card
    runs) the smallest p.Ap and p.Ap / p.p of each CG solve, beside the
    bulk's median of the same."""
    res = json.load(open(src))
    print(f"C={res['C']} L={res['L']} O={res['O']}; float64 dense: "
          f"accept {''.join('1' if a else '0' for a in res['f64_dense']['accept'])}"
          f", lambda {res['f64_dense']['lam']}")
    for key, v in res["runs"].items():
        runs, rel = v["runs"], np.asarray(v["rel"])
        pats = _patterns(runs)
        modal = max(pats, key=pats.get)
        print(f"{key}: {len(runs)} runs, rel min {rel.min():.4e} median "
              f"{np.median(rel):.4e} max {rel.max():.4e}, distinct costs "
              f"{len({r['cost'] for r in runs})}, past 1e-3 / 5e-3 / 1e-2: "
              f"{int((rel > 1e-3).sum())} / {int((rel > 5e-3).sum())} / "
              f"{int((rel > 1e-2).sum())}; modal accept pattern {modal} "
              f"({pats[modal]} runs), patterns {pats}")
        bulk = [r for r, x in zip(runs, rel) if x <= tail]
        for k, (r, x) in enumerate(zip(runs, rel)):
            if x <= tail:
                continue
            pat = "".join("1" if a else "0" for a in r["accept"])
            it = next((i for i, (a, b) in enumerate(zip(pat, modal))
                       if a != b), None)
            line = f"  run {k}: rel {x:.4e}, accept {pat}"
            if it is not None:
                lam_before = r["lam"][it - 1] if it else None
                med = np.median([b["new_cost"][it] for b in bulk]) \
                    if bulk else float("nan")
                line += (f", leaves the modal pattern at LM iteration {it} "
                         f"(lambda before it {lam_before}), proposed cost "
                         f"{r['new_cost'][it]:.9e} against the bulk's "
                         f"median {med:.9e}")
            if "min_pAp" in r and bulk:
                mb = np.median([b["min_pAp"] for b in bulk], 0)
                qb = np.median([b["min_pAp_over_pp"] for b in bulk], 0)
                line += (f"; min p.Ap per solve {np.round(r['min_pAp'], 9).tolist()}"
                         f" (bulk median {np.round(mb, 9).tolist()}), min "
                         f"p.Ap/p.p {np.round(r['min_pAp_over_pp'], 6).tolist()}"
                         f" (bulk median {np.round(qb, 6).tolist()}), first "
                         f"p.Ap <= 0 at CG iteration "
                         f"{r['first_nonpos_cg_iter']}")
            print(line)
        if "min_pAp" in runs[0]:
            allm = np.asarray([r["min_pAp"] for r in runs])
            print(f"  smallest p.Ap over all runs and solves {allm.min():.4e}"
                  f", runs with a p.Ap <= 0: "
                  f"{int((allm <= 0).any(1).sum())}")


if __name__ == "__main__":
    a = sys.argv[1:]
    if a[:1] == ["card"]:
        card(a[1], a[2], _arg(a, "--reps", 100))
    elif a[:1] == ["jax"]:
        jax_orders(a[1], a[2], _arg(a, "--orders", 32))
    elif a[:1] == ["measure"]:
        measure(a[1], a[2])
    elif a[:1] == ["summary"]:
        summary(a[1], _arg(a, "--tail", 1e-3))
    else:
        raise SystemExit(__doc__)

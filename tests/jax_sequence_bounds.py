"""The JAX package's Tracker on the port's sequence features: the figures
chip_smoke.py's sequence, reference and orb phases are bounded by (half
and twice of them).

    python3 chip_smoke.py --save-sequence-features seq_feats.npz \
        --save-reference-features ref_feats.npz \
        --save-orb-features orb_feats.npz
    export JAX_PLATFORMS=cpu PYTHONPATH=.
    python tests/jax_sequence_bounds.py seq_feats.npz
    python tests/jax_sequence_bounds.py ref_feats.npz --profile reference
    python tests/jax_sequence_bounds.py orb_feats.npz --frontend orb
    python tests/jax_sequence_bounds.py seq_feats.npz --sync --seeds 8
    python tests/jax_sequence_bounds.py seq_feats.npz --sync --seeds 8 \
        --tracker port

The npz holds the kernel-path features of the bench sequence's frames
0..55 as the port's tracker detected them (a batch of 8, then batches of
16), the intrinsics and the ground-truth poses. They go through the JAX
Tracker under the config chip_smoke.py ran (--profile fast: FAST_CONFIG,
the default; reference: DEFAULT_CONFIG; --frontend orb: the profile's
config with frontend="orb", whose tracker matches on Hamming distance)
exactly as the port's bench feeds its frames:
process_batch_features over the first batch (bootstrap and two-view init,
then the engine), then over each 16-frame batch (process_stream's result
equals process_batch's, tests/test_torch_tracker.py). Prints one JSON line
of the figures and the bounds derived from them.

--sync runs the window BA synchronously (async_ba=False: the timing of a
Tracker given a mesh). --seeds N runs RANSAC seeds 0..N-1 in place of the
config's one and prints each run's figures, the ATE's median and maximum
over the seeds and the bounds on them (twice each): on these features the
tracker's ATE depends on which inlier set the two-view init's RANSAC
draws, in both packages. --tracker port runs the port's Tracker on the CPU
(its own RANSAC draws) in place of the JAX package's, for comparison;
--replay gives it the JAX package's draws instead (the JAX tracker's key
chain, split once per two-view init, then one Gumbel top-k per hypothesis
key, as tests/test_torch_tracker.py replays them).

--two-view compares the two-view initializations of the JAX tracker and of
the port's tracker under replayed draws, init by init: each package's
RANSAC is rerun step by step on the JAX tracker's inputs with the same
samples (the hypothesis chosen, its inlier mask, the refit, the cheirality
mask), in float32 and in float64 (the JAX package under jax_enable_x64 in
a child process), and each final flag that differs is printed with its
distance from its test's threshold (final_flips) beside delta, the angle
between the two packages' relative poses. One JSON line per init, then a
summary line (with the port's tracker run again with the JAX package's
two-view result in place of its own).
"""

import argparse
import contextlib
import json

import jax

jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from visualslam_tpu.models.types import Features, Keypoints  # noqa: E402
from visualslam_tpu.slam.evaluation import ate_rmse  # noqa: E402
from visualslam_tpu.slam.tracker import Tracker  # noqa: E402
from visualslam_tpu.utils.config import (  # noqa: E402
    DEFAULT_CONFIG,
    FAST_CONFIG,
)


@contextlib.contextmanager
def replayed_draws(seed: int, calls: list | None = None):
    """Inside the block, the port's RANSAC draws the JAX tracker's samples
    (geometry/ransac.sample_indices replaced): PRNGKey(seed), split once
    per call (the JAX tracker splits once per two-view init), then
    split(sub, N) and one Gumbel top-k per key. Each call's sub key is
    appended to `calls` when given."""
    import torch

    from visualslam_tpu.geometry import ransac as jrs
    from visualslam_tpu_torch.geometry import ransac as trs

    state = {"key": jax.random.PRNGKey(seed)}
    original = trs.sample_indices

    def sample(gen, valid, N, n):
        state["key"], sub = jax.random.split(state["key"])
        if calls is not None:
            calls.append(np.asarray(sub))
        keys = jax.random.split(sub, N)
        v = jnp.asarray(valid.cpu().numpy())
        idx = jax.vmap(lambda k: jrs._gumbel_sample_indices(k, v, n))(keys)
        return torch.as_tensor(np.array(idx), device=valid.device)

    trs.sample_indices = sample
    try:
        yield
    finally:
        trs.sample_indices = original


def run(z, cfg, tracker: str, replay: bool = False) -> dict:
    """One tracker over the saved batches; the figures of frames 0..n-1."""
    if replay:
        with replayed_draws(cfg.ransac.seed):
            return run(z, cfg, tracker)
    sizes = [int(s) for s in z["sizes"]]
    if tracker == "jax":
        t = Tracker(cfg, z["intrinsics"])
    else:
        import torch

        from visualslam_tpu_torch.models.types import Features as PFeatures
        from visualslam_tpu_torch.models.types import Keypoints as PKeypoints
        from visualslam_tpu_torch.slam.tracker import Tracker as PTracker
        from visualslam_tpu_torch.utils.config import SlamConfig

        t = PTracker(SlamConfig.from_json(cfg.to_json()), z["intrinsics"],
                     device="cpu")
    first = 0
    for b, size in enumerate(sizes):
        if tracker == "jax":
            kps = Keypoints(*(jnp.asarray(z[f"b{b}_{k}"])
                              for k in Keypoints._fields))
            fb = Features(kps, jnp.asarray(z[f"b{b}_descriptors"]))
        else:
            kps = PKeypoints(*(torch.as_tensor(z[f"b{b}_{k}"])
                               for k in PKeypoints._fields))
            fb = PFeatures(kps, torch.as_tensor(z[f"b{b}_descriptors"]))
        t.process_batch_features(fb, first, 0, size)
        first += size
    n = first
    frames = t.frames[:n]
    assert [f.frame_id for f in frames] == list(range(n))
    est = t.trajectory()[:n, :, 3]
    inl = [f.num_inliers for f in frames if f.num_inliers > 0]
    return dict(frames=n,
                ok=float(np.mean([f.tracking_ok for f in frames])),
                ate=ate_rmse(est, z["gt_poses"][:n, :, 3]),
                keyframes=int(sum(f.is_keyframe for f in frames)),
                mean_inliers=float(np.mean(inl)), min_inliers=int(min(inl)),
                landmarks=int(t.map.lm_valid.sum()),
                loop_closures=t.num_loop_closures,
                relocalizations=t.relocalizations)


def jax_ransac_steps(x1, x2, valid, idx, thr: float) -> dict:
    """The JAX package's ransac_essential + recover_pose step by step on
    given samples idx [N, 8] (numpy in, numpy out; jitted, in the dtype of
    x1)."""
    from visualslam_tpu.geometry.epipolar import (
        eight_point,
        recover_pose,
        sampson_error,
    )

    @jax.jit
    def steps(x1, x2, valid, idx):
        def hyp(ix):
            E = eight_point(x1[ix], x2[ix])
            return E, sampson_error(E, x1, x2)

        Es, errs = jax.vmap(hyp)(idx)
        inls = (errs < thr) & valid
        counts = jnp.sum(inls, axis=1)
        best = jnp.argmax(counts)
        inl0 = inls[best]
        E1 = eight_point(x1, x2, inl0.astype(x1.dtype))
        err1 = sampson_error(E1, x1, x2)
        inl1 = (err1 < thr) & valid
        use = jnp.sum(inl1) >= jnp.sum(inl0)
        E = jnp.where(use, E1, Es[best])
        inl = jnp.where(use, inl1, inl0)
        R, t, X, front = recover_pose(E, x1, x2, inl.astype(x1.dtype))
        return dict(counts=counts, best=best, err0=errs[best], inl0=inl0,
                    err1=err1, inl1=inl1, use=use, epi=inl,
                    err=jnp.where(use, err1, errs[best]), R=R, t=t, X=X,
                    inl=inl & front)

    out = steps(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(valid),
                jnp.asarray(idx))
    return {k: np.asarray(v) for k, v in out.items()}


def port_ransac_steps(x1, x2, valid, idx, thr: float) -> dict:
    """The same steps in the port (geometry/ransac.ransac_essential +
    recover_pose) on the CPU, in the dtype of x1."""
    import torch

    from visualslam_tpu_torch.geometry.epipolar import (
        eight_point,
        recover_pose,
        sampson_error,
    )

    x1, x2 = torch.tensor(x1), torch.tensor(x2)
    valid, idx = torch.tensor(valid), torch.tensor(idx).long()
    Es = eight_point(x1[idx], x2[idx])
    errs = sampson_error(Es, x1, x2)
    inls = (errs < thr) & valid
    counts = inls.sum(-1)
    best = torch.argmax(counts)
    inl0 = inls[best]
    E1 = eight_point(x1, x2, inl0.to(x1.dtype))
    err1 = sampson_error(E1, x1, x2)
    inl1 = (err1 < thr) & valid
    use = inl1.sum() >= inl0.sum()
    E = torch.where(use, E1, Es[best])
    inl = torch.where(use, inl1, inl0)
    R, t, X, front = recover_pose(E, x1, x2, inl.to(x1.dtype))
    out = dict(counts=counts, best=best, err0=errs[best], inl0=inl0,
               err1=err1, inl1=inl1, use=use, epi=inl,
               err=torch.where(use, err1, errs[best]), R=R, t=t, X=X,
               inl=inl & front)
    return {k: v.numpy() for k, v in out.items()}


def jax_steps_x64(inits: list, thr: float) -> list:
    """The JAX package's steps in float64 on [(x1, x2, valid, idx)], run
    in a child process under jax_enable_x64 (this process stays in
    float32)."""
    import os
    import subprocess
    import sys
    import tempfile

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=os.pathsep.join(
        filter(None, [root, os.environ.get("PYTHONPATH")])))
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "inits.npz")
        dst = os.path.join(tmp, "x64.npz")
        np.savez(src, n=len(inits), thr=thr, **{
            f"{k}_{i}": a for i, r in enumerate(inits)
            for k, a in zip(("x1", "x2", "valid", "idx"), r)})
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--x64-worker", src, dst], check=True, env=env)
        z = np.load(dst)
        return [{k[:-len(f"_{i}")]: z[k] for k in z.files
                 if k.endswith(f"_{i}")} for i in range(len(inits))]


def _x64_worker(inputs: str, output: str) -> None:
    """Child process of jax_steps_x64."""
    jax.config.update("jax_enable_x64", True)
    z = np.load(inputs)
    out = {}
    for i in range(int(z["n"])):
        r = jax_ransac_steps(z[f"x1_{i}"].astype(np.float64),
                             z[f"x2_{i}"].astype(np.float64), z[f"valid_{i}"],
                             z[f"idx_{i}"], float(z["thr"]))
        out.update({f"{k}_{i}": v for k, v in r.items()})
    np.savez(output, **out)


def pose_angle(a: dict, b: dict) -> float:
    """delta: the angle in radians between two runs' relative poses (the
    rotation angle of Ra^T Rb plus the angle between the translation
    directions)."""
    dR = np.asarray(a["R"], np.float64).T @ np.asarray(b["R"], np.float64)
    rot = np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1))
    ta, tb = (np.asarray(x["t"], np.float64) for x in (a, b))
    tr = np.arccos(np.clip(ta @ tb / (np.linalg.norm(ta)
                                      * np.linalg.norm(tb)), -1, 1))
    return float(rot + tr)


def final_flips(a: dict, b: dict, thr: float) -> list:
    """The flags of the init's final mask that differ between two runs of
    the steps, each with its distance from its test's threshold in the
    units of the pose angle (radians, unit baseline): ("sampson", i, the
    larger |sqrt(err) - sqrt(thr)| of the two runs) or, where only the
    cheirality test differs, ("cheirality", i, the larger |1 / depth| of
    the two runs: a depth's sign is undetermined once the inverse depth
    is within the models' difference of 0)."""
    out = []
    for i in np.flatnonzero(a["inl"] != b["inl"]):
        if a["epi"][i] != b["epi"][i]:
            d = max(abs(np.sqrt(x["err"][i]) - np.sqrt(thr)) for x in (a, b))
            out.append(("sampson", int(i), float(d)))
        else:
            d = max(1.0 / max(abs(float(x["X"][i, 2])), 1e-12)
                    for x in (a, b))
            out.append(("cheirality", int(i), d))
    return out


def flips(a: dict, b: dict) -> dict:
    """Where two runs of the steps part: the chosen hypotheses, the
    hypotheses whose inlier counts differ, the refit choices, the final
    inlier counts and the final flags that differ."""
    return dict(best=[int(a["best"]), int(b["best"])],
                counts_differ=int((a["counts"] != b["counts"]).sum()),
                max_count_diff=int(np.abs(a["counts"].astype(np.int64)
                                          - b["counts"]).max()),
                use_refit=[bool(a["use"]), bool(b["use"])],
                n_inl=[int(a["inl"].sum()), int(b["inl"].sum())],
                final=[int(i) for i in np.flatnonzero(a["inl"] != b["inl"])])


def two_view_report(z, cfg) -> None:
    """The two-view inits of both trackers on the saved features, the
    port's under replayed draws, each rerun step by step in both packages
    on the JAX tracker's inputs and samples (float32 and float64)."""
    from visualslam_tpu.geometry import ransac as jrs
    from visualslam_tpu_torch.geometry import ransac as trs

    thr = cfg.ransac.inlier_threshold
    N, n = cfg.ransac.num_hypotheses, cfg.ransac.sample_size
    calls = {"jax": [], "port": []}
    orig_port = trs.estimate_relative_pose

    def port_rec(x1, x2, valid, rcfg, gen=None, *kernels):
        out = orig_port(x1, x2, valid, rcfg, gen, *kernels)
        calls["port"].append(dict(x1=x1.numpy(), x2=x2.numpy(),
                                  valid=valid.numpy(),
                                  inl=out[3].numpy()))
        return out

    trs.estimate_relative_pose = port_rec
    keys = []
    try:
        with replayed_draws(cfg.ransac.seed, keys):
            port_fig = run(z, cfg, "port")
    finally:
        trs.estimate_relative_pose = orig_port

    from visualslam_tpu.slam import tracker as jtracker

    orig_init = jtracker.Tracker.__init__

    def init_rec(self, *a, **kw):
        orig_init(self, *a, **kw)
        prog = self._ransac

        def rec(x1, x2, valid, key):
            out = prog(x1, x2, valid, key)
            calls["jax"].append(dict(
                x1=np.asarray(x1), x2=np.asarray(x2),
                valid=np.asarray(valid), key=np.asarray(key),
                inl=np.asarray(out[3])))
            return out

        self._ransac = rec

    jtracker.Tracker.__init__ = init_rec
    try:
        jax_fig = run(z, cfg, "jax")
    finally:
        jtracker.Tracker.__init__ = orig_init

    # the port's tracker with the JAX package's two-view result put in
    # place of its own (the same key chain): what is left of the gap
    import torch

    jpose = jax.jit(lambda x1, x2, v, k: jrs.estimate_relative_pose(
        x1, x2, v, cfg.ransac, k))
    state = {"key": jax.random.PRNGKey(cfg.ransac.seed)}

    def injected(x1, x2, valid, rcfg, gen=None, *kernels):
        state["key"], sub = jax.random.split(state["key"])
        out = jpose(jnp.asarray(x1.numpy()), jnp.asarray(x2.numpy()),
                    jnp.asarray(valid.numpy()), sub)
        return tuple(torch.as_tensor(np.array(o)) for o in out)

    trs.estimate_relative_pose = injected
    try:
        port_injected = run(z, cfg, "port")
    finally:
        trs.estimate_relative_pose = orig_port

    inits = []
    for i, (cj, cp) in enumerate(zip(calls["jax"], calls["port"])):
        keys_i = jax.random.split(jnp.asarray(cj["key"]), N)
        v = jnp.asarray(cj["valid"])
        idx = np.asarray(jax.vmap(
            lambda k: jrs._gumbel_sample_indices(k, v, n))(keys_i))
        same_in = (cj["x1"].shape == cp["x1"].shape
                   and bool((cj["valid"] == cp["valid"]).all()))
        inits.append(dict(
            x1=cj["x1"], x2=cj["x2"], valid=cj["valid"], idx=idx,
            tracker_flags=int((cj["inl"] != cp["inl"]).sum())
            if same_in else None,
            inputs_equal=same_in and bool(
                (cj["x1"] == cp["x1"]).all() and (cj["x2"] == cp["x2"]).all()),
            key_equal=bool(i < len(keys)
                           and (np.asarray(keys[i]) == cj["key"]).all())))

    j64 = jax_steps_x64([(r["x1"], r["x2"], r["valid"], r["idx"])
                         for r in inits], thr)

    worst, flips32, flips64 = {}, 0, 0
    for i, r in enumerate(inits):
        args = (r["x1"], r["x2"], r["valid"], r["idx"], thr)
        j32 = jax_ransac_steps(*args)
        p32 = port_ransac_steps(*args)
        p64 = port_ransac_steps(r["x1"].astype(np.float64),
                                r["x2"].astype(np.float64), *args[2:])
        f32 = flips(j32, p32)
        f64 = flips(j64[i], p64)
        f32["final"] = final_flips(j32, p32, thr)
        f32["delta"] = delta = pose_angle(j32, p32)
        for kind, _, d in f32["final"]:
            worst[kind] = max(worst.get(kind, 0.0), d / max(delta, 1e-12))
        flips32 += len(f32["final"])
        flips64 += len(f64["final"])
        print(json.dumps(dict(
            init=i, matches=int(r["valid"].sum()),
            inputs_equal=r["inputs_equal"], key_equal=r["key_equal"],
            tracker_flags_differ=r["tracker_flags"],
            jax_steps_equal_tracker=bool(
                (j32["inl"] == calls["jax"][i]["inl"]).all()),
            f32=f32, f64=f64,
            f32_vs_f64=dict(jax=flips(j32, j64[i])["final"],
                            port=flips(p32, p64)["final"]))))
    print(json.dumps(dict(inits=[len(calls["jax"]), len(calls["port"])],
                          jax=jax_fig, port=port_fig,
                          port_with_jax_two_view=port_injected,
                          final_flags_differ_f32=flips32,
                          final_flags_differ_f64=flips64,
                          max_flip_distance_over_delta=worst)))


def main(path: str, profile: str = "fast", frontend: str = "sift",
         sync: bool = False, seeds: int = 0, tracker: str = "jax",
         replay: bool = False, two_view: bool = False) -> None:
    z = np.load(path)
    cfg = FAST_CONFIG if profile == "fast" else DEFAULT_CONFIG
    cfg = cfg.replace(frontend=frontend)
    if sync:
        cfg = cfg.replace(ba=cfg.ba.replace(async_ba=False))
    if two_view:
        two_view_report(z, cfg)
        return
    if seeds:
        runs = [run(z, cfg.replace(ransac=cfg.ransac.replace(seed=s)),
                    tracker, replay) for s in range(seeds)]
        ate = [r["ate"] for r in runs]
        out = dict(ate_median=float(np.median(ate)), ate_max=max(ate))
        print(json.dumps({tracker: runs, **out,
                          "bounds": {k: 2.0 * v for k, v in out.items()}}))
        return
    fig = run(z, cfg, tracker, replay)
    bounds = dict(ok=0.5 * fig["ok"], ate=2.0 * fig["ate"],
                  keyframes=[fig["keyframes"] // 2, 2 * fig["keyframes"]],
                  mean_inliers=[0.5 * fig["mean_inliers"],
                                2.0 * fig["mean_inliers"]])
    print(json.dumps({tracker: fig, "bounds": bounds}))


if __name__ == "__main__":
    import sys

    if sys.argv[1:2] == ["--x64-worker"]:
        _x64_worker(*sys.argv[2:4])
        sys.exit()
    p = argparse.ArgumentParser()
    p.add_argument("features")
    p.add_argument("--profile", default="fast", choices=["fast", "reference"])
    p.add_argument("--frontend", default="sift", choices=["sift", "orb"])
    p.add_argument("--sync", action="store_true")
    p.add_argument("--seeds", type=int, default=0)
    p.add_argument("--tracker", default="jax", choices=["jax", "port"])
    p.add_argument("--replay", action="store_true",
                   help="with --tracker port: the JAX package's RANSAC draws")
    p.add_argument("--two-view", action="store_true",
                   help="compare both trackers' two-view inits (replayed)")
    a = p.parse_args()
    if a.replay and a.tracker != "port":
        p.error("--replay needs --tracker port")
    main(a.features, a.profile, a.frontend, a.sync, a.seeds, a.tracker,
         a.replay, a.two_view)

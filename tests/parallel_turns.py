"""The parallel phase's pieces of one checkout, timed: a turn of a
before / after comparison on one card.

    python tests/parallel_turns.py ROOT [--profile-eager]

Runs `chip_smoke.py`'s parallel pieces from the checkout at ROOT on a
4-shard virtual mesh of the card: the dry run, the data-parallel
frontend, the C = 1024 matrix-free solve, the window-size solves, the
sharded 2-NN where the checkout has it, and the mesh tracker (not the
global BA, which needs the KITTI-scale run's tracker, nor the pipeline),
each with that checkout's own checks; then prints one JSON line of each
piece's seconds and the checkout's program figures. With
`--profile-eager`, each program check of a checkout that has them
(`chip_smoke.mesh_program_check`) also profiles its eager call: host
launch calls, device kernels and busy share of both paths (the phase
itself profiles only the C = 1024 solve's, for time). Compare two checkouts
in one call and in turns, each turn a process of its own, e.g. parent,
change, change, parent:

    for r in parent . . parent; do python tests/parallel_turns.py $r; done

(`parent`: the parent commit unpacked with `git archive`).
"""

import inspect
import json
import os
import sys
import time


def main(root: str, profile_eager: bool) -> None:
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    import numpy as np
    import torch

    import chip_smoke as cs
    from visualslam_tpu_torch.parallel.mesh import make_mesh

    if profile_eager and hasattr(cs, "mesh_program_check"):
        check = cs.mesh_program_check
        cs.mesh_program_check = lambda *a, **kw: check(
            *a, **dict(kw, profile_eager=True))

    dev, _ = cs.phase_device()
    cs.phase_build()
    frames, _ = cs.render_frames()
    frames_dev = torch.from_numpy(frames).to(dev)
    frontend = cs.SiftFrontend(cs.FAST_CONFIG).to(dev)
    frontend(frames_dev[:cs.BATCH])
    seq = cs.SyntheticSequence(num_frames=cs.PAR_SEQ_FRAMES, h=cs.H,
                               w=cs.W, n_dots=8000, step=0.4)
    extra = np.stack([seq.frame(k) for k in range(len(frames),
                                                  cs.PAR_SEQ_FRAMES)])
    frames = np.concatenate(
        [frames, np.clip(extra * 255.0, 0, 255).astype(np.uint8)])
    fdev = torch.from_numpy(frames[:cs.PAR_FRAMES[1]]).to(dev)
    mesh = make_mesh(cs.PAR_SHARDS, devices=[dev] * cs.PAR_SHARDS)
    figs, sec = [], {}
    t_all = time.perf_counter()

    def piece(name, fn, *a):
        if "figs" in inspect.signature(fn).parameters:
            a = a + (figs,)
        t0 = time.perf_counter()
        out = fn(*a)
        sec[name] = round(time.perf_counter() - t0, 1)
        return out

    if hasattr(cs, "par_dryrun"):
        figs += piece("dryrun", cs.par_dryrun, mesh, "virtual", True)
    else:
        from visualslam_tpu_torch.parallel.dryrun import run_dryrun
        piece("dryrun", run_dryrun, cs.PAR_SHARDS, list(mesh.devices))
    piece("frontend", cs.par_frontend, mesh, frontend, fdev, "virtual")
    piece("traj_mf", cs.par_traj_mf, mesh, dev, "virtual")
    piece("window", cs.par_window, mesh, dev, "virtual")
    if hasattr(cs, "par_2nn"):
        figs.append(piece("2nn", cs.par_2nn, mesh, dev, "virtual"))
    piece("tracker", cs.par_tracker, mesh, frames, seq, dev, "virtual")
    print(json.dumps({"turn": root, "pieces_s": sec,
                      "total_s": round(time.perf_counter() - t_all, 1),
                      "parallel_programs": figs}))


if __name__ == "__main__":
    main(sys.argv[1], "--profile-eager" in sys.argv[2:])

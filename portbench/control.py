"""The frontend check's readings, on the card at a cell's own size:

    python3 -m portbench.control --workload <cell> --seeds 1,2,3

It renders the cell's frames, runs the tracker's frontend
(`Tracker.detect_batch`, the window's frontend program) once on every
stream batch of a drive, and judges each batch's frames by the plain
frontend (reference/frontend): the program's output, the control's (the
plain frontend in the precision below the configuration's, put in the
program's place at the same keypoints) and the output with the fault
`answer_altered` planted. A seed reads the worst of the batches the run
would sample for it (check.sample_batches). With `--fault NAME` it
instead runs the cell's first drive with a fault of faults.py planted in
the program and prints every number compared. One JSON line per seed;
the benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import json
import sys


def batch_readings(cell, device="cuda", world_kw=None, traffic=None,
                   cache=None) -> tuple:
    """(per stream batch {"program", "control", "answer_altered"} numbers,
    the number of batches)."""
    import numpy as np
    import torch

    from portbench import check, drive, faults
    from portbench.run import frames_of
    from portbench.world import World
    from visualslam_tpu_torch.slam.tracker import Tracker
    from visualslam_tpu_torch.utils.config import SlamConfig

    cfg_dict = cell.config["slam"]
    traffic = traffic or drive.Traffic.from_dict(cell.traffic)
    wk = world_kw or cell.config["world"]
    world = World(wk["scene_seed"], wk["h"], wk["w"], wk["n_dots"],
                  wk["step"], traffic.frames_per_lap)
    seq = drive.Sequence(frames_of(world, wk, traffic.distinct(), device,
                                   cache), traffic)
    tracker = Tracker(SlamConfig.from_dict(cfg_dict), world.intrinsics,
                      device=device)
    out = []
    for i in range(len(seq.batches)):
        imgs = check.padded(seq.batches[i][1], traffic.batch)
        feats = tracker.detect_batch(
            torch.from_numpy(np.ascontiguousarray(imgs)))
        got = {}
        for kind, f, ctl in (("program", feats, False),
                             ("control", feats, True),
                             ("answer_altered", faults.alter(feats), False)):
            got[kind] = check.frontend_numbers(seq, {("first", i): f},
                                               cfg_dict, device, ctl)
        out.append(got)
    return out, len(seq.batches)


def seed_readings(per_batch: list, seed: int, k: int) -> dict:
    """The worst of the batches a run samples for `seed`."""
    from portbench import check

    got: dict = {}
    for i in check.sample_batches(seed, len(per_batch), k):
        for kind, nums in per_batch[i].items():
            side = got.setdefault(kind, {})
            for name, v in nums.items():
                side[name] = max(side.get(name, 0.0), v)
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.control")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    from portbench import drive, faults, spec
    from portbench.run import CACHE, _cache_dirs, run_cell

    _cache_dirs()
    cell = spec.find_cell(args.workload)
    seeds = [int(s) for s in args.seeds.split(",")]
    if args.fault is None:
        per_batch, _ = batch_readings(cell, cache=CACHE)
        k = drive.Traffic.from_dict(cell.traffic).check_batches
        for seed in seeds:
            print(json.dumps({"workload": cell.name, "seed": seed,
                              **seed_readings(per_batch, seed, k)}),
                  flush=True)
        return 0
    for seed in seeds:
        with faults.FAULTS[args.fault]():
            got = run_cell(cell, seed, 0.0, False)["compared"]
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "fault": args.fault, **got}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

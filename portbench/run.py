"""The benchmark of `visualslam_tpu_torch` on one card: one cell, one run.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

from the root of a checkout. The cell is an entry of `BENCHMARK.json`; its
configuration, traffic mix and per-layer metrics are files under
`portbench/` found by name (spec.py). Set-up holds the cell's frames in
host memory (rendered on the card by world.py once per checkout and kept
in `_cache/`) and runs a warm drive; the window then runs drives back to
back (drive.py); the outputs are checked against the plain reference
once the window has closed (check.py). The last line of standard output is one JSON object:
`correct`, `attempted`, `failed`, `metrics`, `device` (and `breakdown`
with --trace 1), and last `compared`, each number compared beside its
limit, which also end standard error.

Exit codes: 0 a result; 2 bad arguments or no such cell; 4 the program
is not in the checkout; 3 no card, or fewer cards than the cell asks
for; 5 JAX or the JAX package was loaded.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CACHE = ROOT / "portbench" / "_cache"


def _cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout (the port
    builds its own kernels under visualslam_tpu_torch/_build/)."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)


def _log(msg: str) -> None:
    print(f"[portbench] {msg}", file=sys.stderr, flush=True)


def frames_of(world, wk: dict, n: int, device, cache: Path | None):
    """The world's first n frames [n, H, W] uint8 in host memory: rendered
    on the device, once per checkout where `cache` is a directory (kept
    there under a name made of the world's parameters and n), and read
    from there by every later run."""
    import numpy as np

    path = None
    if cache is not None:
        path = cache / ("frames-{scene_seed}-{h}x{w}-{n_dots}-{step}-"
                        "{lap}-{n}.npy").format(**wk, lap=world.q * 4, n=n)
        if path.exists():
            return np.load(path)
    host = world.render(range(n), device).cpu().numpy()
    if path is not None:
        path.parent.mkdir(parents=True, exist_ok=True)
        part = path.with_name(path.name + ".part")
        with open(part, "wb") as f:
            np.save(f, host)
        os.replace(part, path)
    return host


def run_cell(cell, seed: int, seconds: float, trace: bool, device="cuda",
             t0: float | None = None, world_kw: dict | None = None,
             traffic=None, limits: dict | None = None,
             frame_cache: Path | None = CACHE) -> dict:
    """One run of `cell`; returns the result's dict, `compared` last.
    world_kw, traffic and limits replace the cell's (the CPU tests run
    small worlds, with frame_cache None: rendered afresh)."""
    import torch

    from portbench import check, drive, stats
    from portbench import trace as tr
    from portbench.world import World
    from visualslam_tpu_torch.slam.tracker import Tracker
    from visualslam_tpu_torch.utils.config import SlamConfig

    t0 = T0 if t0 is None else t0
    cuda = torch.device(device).type == "cuda"
    cfg_dict = cell.config["slam"]
    cfg = SlamConfig.from_dict(cfg_dict)
    traffic = traffic or drive.Traffic.from_dict(cell.traffic)
    wk = world_kw or cell.config["world"]

    t = time.perf_counter()
    world = World(wk["scene_seed"], wk["h"], wk["w"], wk["n_dots"],
                  wk["step"], traffic.frames_per_lap)
    host = frames_of(world, wk, traffic.distinct(), device, frame_cache)
    seq = drive.Sequence(host, traffic)
    gt = world.centers(traffic.frames)
    _log(f"{len(host)} frames of {wk['h']}x{wk['w']} in "
         f"{time.perf_counter() - t:.3f} s")

    def make_tracker():
        return Tracker(cfg, world.intrinsics, device=device)

    t = time.perf_counter()
    drive.warm(make_tracker, seq, device)
    gc.collect()            # the warm drive's garbage, before the window
    _log(f"{traffic.warm_drives} warm drives in "
         f"{time.perf_counter() - t:.3f} s")
    setup_s = time.perf_counter() - t0

    hooks = drive.Hooks()
    if trace:
        hooks = tr.TraceHooks(traffic, cfg_dict, cuda)
        hooks.prepare()
    capture = check.sample_batches(seed, len(seq.batches),
                                   traffic.check_batches)
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    rec = drive.run_window(make_tracker, seq, seconds, device, hooks,
                           frozenset(capture))
    mem_peak = torch.cuda.max_memory_allocated() if cuda else 0
    _log(f"window {rec.seconds:.3f} s: {len(rec.drives)} drives "
         f"({sum(d.complete for d in rec.drives)} complete), "
         f"{rec.handed} frames handed in, {rec.delivered_ok()} tracked, "
         f"{rec.lost()} lost, {rec.undelivered()} undelivered; drive s "
         f"{[round(d.seconds, 3) for d in rec.drives]}, closures "
         f"{[d.closures for d in rec.drives]}, relocalizations "
         f"{[d.relocalizations for d in rec.drives]}; the first drive's "
         f"loops (frame, frame) {rec.drives[0].loops}")

    result = {"correct": False, "attempted": rec.handed,
              "failed": rec.lost() + rec.undelivered()}
    if trace:
        imgs = check.padded(seq.batches[capture[0]][1], traffic.batch)
        fms = tr.frontend_ms(make_tracker(), imgs) if cuda else []
        record = hooks.record(fms, wk["h"], wk["w"])
        record["latencies_s"] = list(rec.latencies)
        from portbench import spec

        result["metrics"] = spec.read_metrics(cell, record)
        bd = tr.breakdown(record)
        sl = record["slice"]
    else:
        result["metrics"] = {}
        values = {
            "frames_per_s": (rec.delivered_ok() / rec.seconds, "frames/s"),
            "pose_latency_p95_ms": (1e3 * stats.p95(rec.latencies), "ms"),
            "device_mem_peak_gib": (mem_peak / 2 ** 30, "GiB"),
            "setup_s": (setup_s, "s"),
        }
        for m in cell.end_to_end:
            v, unit = values[m["name"]]
            result["metrics"][m["name"]] = {"value": v, "unit": unit}

    # the check, once the window has closed and its memory peak was read
    captures = rec.captures
    rec.captures = {}
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t = time.perf_counter()
    numbers = check.frontend_numbers(seq, captures, cfg_dict, device)
    numbers.update(check.pose_numbers(rec, gt))
    numbers["undelivered"] = float(rec.undelivered())
    limits = limits or cell.limits
    correct, rows = check.verdict(numbers, limits)
    _log(f"check in {time.perf_counter() - t:.3f} s; not compared: "
         f"{ {k: v for k, v in numbers.items() if k not in limits} }")
    result["correct"] = bool(correct)

    result["device"] = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name() if cuda else "cpu",
        "count": cell.chips, "memory_peak_bytes": int(mem_peak)}
    if trace:
        if sl is not None:
            busy = stats.union_length([(s, e) for _, s, e in sl["device"]])
            result["device"]["busy_s"] = busy
            result["device"]["window_s"] = sl["end_s"] - sl["start_s"]
        if bd is not None:
            result["breakdown"] = bd
    result["compared"] = {name: {"value": v, "limit": lim}
                          for name, v, lim in rows}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="portbench.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_dirs()

    from portbench import guard, spec

    try:
        cell = spec.find_cell(args.workload)
    except (KeyError, FileNotFoundError) as e:
        _log(f"no cell: {e}")
        return 2
    try:
        import visualslam_tpu_torch
    except ImportError as e:
        _log(f"the program is not in this checkout: {e}")
        return 4
    if ROOT not in Path(visualslam_tpu_torch.__file__).resolve().parents:
        _log(f"the program was found outside the checkout: "
             f"{visualslam_tpu_torch.__file__}")
        return 4
    import torch

    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        _log(f"needs {cell.chips} CUDA device(s); torch sees "
             f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    bad = guard.forbidden_modules()
    if bad:
        _log(f"JAX or the JAX package was loaded: {bad}")
        return 5
    for name, c in result["compared"].items():
        print(f"compared {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

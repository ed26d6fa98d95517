"""The reductions and the per-layer readers, on synthetic records."""

import math
import random

import pytest

from portbench import spec, stats, trace


def test_p95_over_all_samples():
    xs = list(range(1, 101))
    random.Random(0).shuffle(xs)
    assert stats.p95(xs) == 95
    assert stats.p95([5.0]) == 5.0
    assert stats.p95([1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
                      16, 17, 18, 19, 1000]) == 19
    assert stats.p95([1] * 19 + [1000, 1000]) == 1000
    with pytest.raises(ValueError):
        stats.p95([])


def test_union_and_gaps_of_intervals():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6), (10.0, 11.0)]
    assert stats.union_length(iv) == pytest.approx(4.0)
    assert stats.union_length([]) == 0.0
    assert stats.gaps(iv, 0.0, 12.0) == [(2.0, 3.0), (4.0, 10.0),
                                          (11.0, 12.0)]
    assert stats.gaps(iv, -1.0, 3.5) == [(-1.0, 0.0), (2.0, 3.0)]


def _record():
    dev = [("k1", 0.0, 0.1), ("k2", 0.05, 0.2), ("Memcpy HtoD", 0.3, 0.35),
           ("extrema_winners_kernel<true>", 0.4, 0.5),
           ("void patch_hist_kernel<true, true>(Params)", 0.5, 0.6)]
    return {
        "stage_totals": {"engine_dispatch": 1.5, "loop_optimize": 0.4},
        "stage_counts": {"engine_dispatch": 10, "loop_optimize": 2},
        "syncs": [18, 18, 20], "global_ba_s": [0.05, 0.07],
        "frontend_ms": [9.0, 9.5, 9.2],
        "latencies_s": [0.01 * i for i in range(1, 101)],
        "slice": {"start_s": 0.0, "end_s": 1.0, "device": dev,
                  "stages": [("engine_dispatch", 0.1, 0.38),
                             ("frontend_dispatch", 0.22, 0.3)],
                  "frames": 32, "sift_bound_s": 0.05},
    }


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_readers():
    rec = _record()
    assert read("device_idle_share", rec) == pytest.approx(100 * (1 - 0.45))
    assert read("device_kernels_per_frame", rec) == pytest.approx(4 / 32)
    assert read("host_syncs_per_batch", rec) == pytest.approx(56 / 3)
    assert read("engine_ms_per_batch", rec) == pytest.approx(150.0)
    assert read("loop_optimize_ms_per_closure", rec) == pytest.approx(200.0)
    assert read("pose_latency_p95_ms.orb", rec) == pytest.approx(950.0)
    assert read("frontend_ms_per_batch", rec) == pytest.approx(9.2)
    assert read("sift_kernels_roofline", rec) == pytest.approx(25.0)


def test_readers_find_nothing_to_read():
    empty = {"stage_totals": {}, "stage_counts": {}, "syncs": [],
             "global_ba_s": [], "frontend_ms": [], "slice": None}
    for m in spec.benchmark()["per_layer"]:
        assert read(m["name"], empty) is None, m["name"]
    rec = _record()
    rec["slice"]["sift_bound_s"] = None      # an ORB cell
    assert read("sift_kernels_roofline", rec) is None


def test_breakdown_names_gaps_by_the_hosts_stage():
    bd = trace.breakdown(_record())
    assert bd["device_ops"][0] == ["k2", pytest.approx(0.15)]
    assert len(bd["device_ops"]) == 5
    gaps = dict(bd["idle_gaps"])
    # gaps: 0.2-0.3 (engine_dispatch's, then frontend_dispatch's middle at
    # 0.25 -> frontend_dispatch), 0.35-0.4 (engine_dispatch), 0.6-1.0
    assert gaps["frontend_dispatch"] == pytest.approx(0.1)
    assert gaps["engine_dispatch"] == pytest.approx(0.05)
    assert gaps["harness"] == pytest.approx(0.4)
    assert math.isclose(sum(gaps.values()), 0.55)

"""The readers of the program's own spans (host_sync_wait_ms_per_batch,
engine_idle_ms_per_batch, loop_pose_graph_ms_per_closure) on a hand-built
record with known gaps and totals, and on records without those spans
(a program that does not report them)."""

import copy

import pytest

from portbench import spec

SPANS = ("host_sync_wait_ms_per_batch", "engine_idle_ms_per_batch",
         "loop_pose_graph_ms_per_closure")


def _record():
    # device gaps: 0.10-0.15, 0.30-0.50, 0.60-0.80, 0.90-1.00
    dev = [("k1", 0.0, 0.1), ("k2", 0.15, 0.3), ("k3", 0.5, 0.6),
           ("k4", 0.8, 0.9)]
    stages = [
        # dispatch 1: its parts cover 0.05-0.55, its tail 0.55-0.70 not
        ("engine_dispatch", 0.05, 0.70),
        ("engine_load", 0.05, 0.12), ("engine_step", 0.12, 0.20),
        ("sync_need", 0.20, 0.35), ("engine_promote", 0.35, 0.45),
        ("engine_pack", 0.45, 0.55),
        # dispatch 2: 0.75-0.95
        ("engine_dispatch", 0.75, 0.95),
        ("engine_step", 0.75, 0.85), ("sync_need", 0.85, 0.95),
        # not an engine part, though it overlaps a gap
        ("frontend_dispatch", 0.60, 0.70), ("capture", 0.30, 0.40),
    ]
    return {
        "stage_totals": {"engine_dispatch": 5.0, "loop_optimize": 0.5,
                         "loop_pose_graph": 0.3, "sync_need": 0.3,
                         "sync_kill_upload": 0.06, "sync_readback": 0.24},
        "stage_counts": {"engine_dispatch": 30, "loop_optimize": 2,
                         "loop_pose_graph": 2, "sync_need": 480,
                         "sync_kill_upload": 60, "sync_readback": 30},
        "syncs": [18, 18, 18], "global_ba_s": [], "frontend_ms": [],
        "slice": {"start_s": 0.0, "end_s": 1.0, "device": dev,
                  "stages": stages, "frames": 32, "sift_bound_s": None},
    }


def read(name, rec):
    return spec.metric_reader(name)(rec)


def test_span_readers_give_the_known_values():
    rec = _record()
    assert read("host_sync_wait_ms_per_batch", rec) == pytest.approx(
        1e3 * 0.6 / 3)
    # gaps inside the parts: 0.05 + 0.20 (dispatch 1), 0.05 + 0.05
    # (dispatch 2); the gap 0.55-0.70 in dispatch 1's tail is not its parts'
    assert read("engine_idle_ms_per_batch", rec) == pytest.approx(
        1e3 * 0.35 / 2)
    assert read("loop_pose_graph_ms_per_closure", rec) == pytest.approx(
        1e3 * 0.3 / 2)


def test_overlapping_parts_count_a_gap_once():
    rec = _record()
    rec["slice"]["stages"].append(("engine_step", 0.30, 0.50))
    assert read("engine_idle_ms_per_batch", rec) == pytest.approx(
        1e3 * 0.35 / 2)


def _without_spans(rec):
    """The record of a program whose stages are the tracker's alone."""
    rec = copy.deepcopy(rec)
    for d in (rec["stage_totals"], rec["stage_counts"]):
        for k in [k for k in d if k.startswith("sync_")
                  or k == "loop_pose_graph"]:
            del d[k]
    rec["slice"]["stages"] = [r for r in rec["slice"]["stages"]
                              if r[0] in ("engine_dispatch",
                                          "frontend_dispatch")]
    return rec


@pytest.mark.parametrize("name", SPANS)
def test_span_readers_without_their_spans(name):
    assert read(name, _without_spans(_record())) is None


def test_span_readers_with_nothing_to_read():
    rec = _record()
    rec["syncs"] = []
    assert read("host_sync_wait_ms_per_batch", rec) is None
    rec["slice"] = None
    assert read("engine_idle_ms_per_batch", rec) is None
    rec["stage_counts"]["loop_optimize"] = 0
    assert read("loop_pose_graph_ms_per_closure", rec) is None


def test_the_span_metrics_are_declared():
    per_layer = {m["name"]: m for m in spec.benchmark()["per_layer"]}
    for name in SPANS:
        assert per_layer[name]["moves"] == "frames_per_s"
    assert "workloads" not in per_layer["engine_idle_ms_per_batch"]
    assert "workloads" not in per_layer["host_sync_wait_ms_per_batch"]

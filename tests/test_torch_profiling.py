"""The port's spans (utils/profiling.py) on the CPU: the no-op without a
sink, StageTimer, and a short engine-path stream drive (the rendered
120x160 frames of tests/test_torch_tracker.py) whose spans are counted
against what the engine did, on the eager engine batch and on the graph
program's data flow run uncaptured; the CPU profiler sees them only as
`stage:` ranges inside `engine_dispatch`. Also the loop closer's
`loop_pose_graph` span and `cli run --trace`."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from tracker_scene import CFG
from visualslam_tpu_torch.cli import main
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.slam import engine
from visualslam_tpu_torch.slam.loop_closure import LoopCloser
from visualslam_tpu_torch.slam.tracker import Tracker
from visualslam_tpu_torch.utils import config, profiling
from visualslam_tpu_torch.utils.config import SlamConfig
from visualslam_tpu_torch.utils.profiling import StageTimer, sink, span

PCFG = SlamConfig.from_json(CFG.to_json())
RCFG = PCFG.replace(
    pyramid=PCFG.pyramid.replace(num_octaves=2, initial_upsample=False),
    sift=PCFG.sift.replace(max_keypoints_per_octave=256, max_keypoints=512))
FRAMES, BATCH = 12, 4
ENGINE_PARTS = ("engine_load", "engine_step", "sync_need", "engine_promote",
                "engine_pack")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_span_without_a_sink_is_the_shared_noop():
    assert profiling._sink is None
    assert span("engine_step") is span("sync_need") is profiling._NULL
    t = StageTimer()
    with sink(t):
        with sink(None):
            with span("inner"):
                pass
        assert span("outer") is not profiling._NULL
    assert profiling._sink is None and not t.counts


def test_stage_timer_records_a_stage_that_raises():
    t = StageTimer()
    with pytest.raises(ValueError):
        with t.stage("fails"):
            raise ValueError("body")
    assert t.counts["fails"] == 1 and t.totals["fails"] >= 0.0
    assert t.summary()["fails"]["count"] == 1


def _uncaptured_batch(monkeypatch):
    """EngineProgram replays `_BatchGraphs(graphs=False)`: the graph
    program's data flow and its spans, run uncaptured on the CPU."""
    keys = {}

    def call(self, persist, dyn, feats_b, intr, kernels=engine.KERNELS):
        key = engine._signature(persist, feats_b, intr, dyn.kill,
                                dyn.kill_gen)
        if key not in keys:
            keys[key] = engine._BatchGraphs(self, persist, dyn, feats_b, intr,
                                            kernels, graphs=False)
        return keys[key].run(persist, dyn, feats_b, intr)

    monkeypatch.setattr(engine.EngineProgram, "__call__", call)


def _drive(monkeypatch, profile: bool) -> dict:
    """A stream drive with a StageTimer; the engine's own account of each
    batch (active frames, promotions from the packed stats rows) beside
    it, and the CPU profiler's events when `profile`."""
    seq = SyntheticSequence(num_frames=FRAMES, h=120, w=160, n_dots=400)
    imgs = np.stack([seq.frame(k) for k in range(FRAMES)])
    tracker = Tracker(RCFG, seq.intrinsics, device="cpu")
    tracker.timer = StageTimer()
    did = {"active": 0, "promoted": 0, "batches": 0}
    batch = tracker._engine_batch

    def spy(persist, dyn, feats_b):
        packed, p = batch(persist, dyn, feats_b)
        B = feats_b.keypoints.valid.shape[0]
        stats = packed[:B * 24].reshape(B, 24)
        did["batches"] += 1
        did["active"] += dyn.stop - dyn.start
        did["promoted"] += int((stats[dyn.start:dyn.stop, 22] > 0.5).sum())
        return packed, p

    monkeypatch.setattr(tracker, "_engine_batch", spy)
    prof = None
    if profile:
        prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU])
    with prof or contextlib.nullcontext():
        for k in range(0, FRAMES, BATCH):
            tracker.process_stream(imgs[k:k + BATCH], k)
        tracker.finish()
    return {"timer": tracker.timer, "did": did, "tracker": tracker,
            "events": prof.events() if profile else None}


@pytest.fixture(scope="module")
def drives():
    mp = pytest.MonkeyPatch()
    try:
        out = {"eager": _drive(mp, profile=True)}
        _uncaptured_batch(mp)
        out["graphs"] = _drive(mp, profile=False)
    finally:
        mp.undo()
    return out


@pytest.mark.parametrize("path", ["eager", "graphs"])
def test_engine_spans_count_what_the_engine_did(drives, path):
    d = drives[path]
    c, did = d["timer"].counts, d["did"]
    assert did["batches"] == c["engine_dispatch"] >= 2
    assert did["active"] > 0 and did["promoted"] > 0
    assert c["engine_step"] == c["sync_need"] == did["active"]
    assert c["engine_promote"] == did["promoted"] == c["kf_apply"]
    assert c["engine_load"] == c["engine_pack"] == c["engine_dispatch"]
    assert c["sync_kill_upload"] == 2 * c["engine_dyn"]
    # the tracker's own stages still report through the same sink
    assert c["frontend_dispatch"] == FRAMES // BATCH
    assert profiling._sink is None


def test_spans_are_stage_ranges_inside_engine_dispatch(drives):
    events = drives["eager"]["events"]
    names = set(drives["eager"]["timer"].counts)
    ranges = {}
    for e in events:
        assert e.name not in names, f"unprefixed range {e.name}"
        if e.name.startswith(profiling.STAGE):
            ranges.setdefault(e.name[len(profiling.STAGE):], []).append(
                (e.time_range.start, e.time_range.end))
    assert set(ranges) == names
    for name in names:
        assert len(ranges[name]) == drives["eager"]["timer"].counts[name]
    outer = ranges["engine_dispatch"]
    for name in ENGINE_PARTS:
        for s, e in ranges[name]:
            assert any(a <= s and e <= b for a, b in outer), name


def test_loop_pose_graph_span_inside_optimize():
    lc = LoopCloser(np.array([500, 500, 320, 240], np.float32), PCFG.match,
                    PCFG.pose_graph, device="cpu", use_sim3=True)
    for k in range(6):
        lc.add_keyframe_light(k, np.eye(3, dtype=np.float32),
                              np.array([0.0, 0.0, -0.5 * k], np.float32))
    lc.add_device_edge(0, 5, np.eye(3, dtype=np.float32),
                       np.array([0.0, 0.0, 0.1], np.float32), 80, 1.05)
    t = StageTimer()
    with sink(t):
        with span("loop_optimize"):
            assert lc.optimize().shape == (6, 3)
    assert t.counts["loop_pose_graph"] == t.counts["loop_optimize"] == 1
    # the graph's eleven pageable uploads and the three reads of its
    # result: host syncs on the card
    assert t.counts["sync_loop_upload"] == 11
    assert t.counts["sync_pose_graph_read"] == 3
    assert t.totals["loop_pose_graph"] <= t.totals["loop_optimize"]


def test_cli_run_trace_writes_the_trace_and_the_stages(tmp_path,
                                                       monkeypatch):
    monkeypatch.setattr(config, "FAST_CONFIG", config.FAST_CONFIG.replace(
        sift=config.FAST_CONFIG.sift.replace(
            max_keypoints=256, max_keypoints_per_octave=128)))
    monkeypatch.chdir(tmp_path)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        main(["run", "--synthetic", "6", "--batch", "3", "--device", "cpu",
              "--no-prewarm", "--metrics", "", "--height", "120",
              "--width", "160", "--dots", "400", "--trace", "tr"])
    assert "wrote tr/trace.json and stages.json" in out.getvalue()
    stages = json.load(open(tmp_path / "tr" / "stages.json"))
    assert stages["frontend_dispatch"]["count"] == 2
    with open(tmp_path / "tr" / "trace.json") as f:
        trace = json.load(f)
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "stage:frontend_dispatch" in names
    assert os.path.exists(tmp_path / "poses_est.txt")

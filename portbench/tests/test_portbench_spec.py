"""The harness finds cells, configurations, mixes and metrics by name, so
a new one is new files and new entries."""

import json
import shutil

import pytest

from portbench import spec
from portbench.drive import Traffic


def test_every_cell_resolves():
    bench = spec.benchmark()
    names = [w["name"] for w in bench["workloads"]]
    assert names == ["kitti-fast.drive", "kitti-orb.drive"]
    for name in names:
        cell = spec.find_cell(name)
        assert cell.chips == 1
        Traffic.from_dict(cell.traffic)
        assert {"frames_per_s", "device_mem_peak_gib", "setup_s"} <= {
            m["name"] for m in cell.end_to_end}
        for m in cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
            assert m["moves"] in {e["name"] for e in cell.end_to_end}
    fast = spec.find_cell("kitti-fast.drive")
    assert "pose_latency_p95_ms" in {m["name"] for m in fast.end_to_end}
    orb = spec.find_cell("kitti-orb.drive")
    assert "pose_latency_p95_ms" not in {m["name"] for m in orb.end_to_end}
    layer = {m["name"] for m in orb.per_layer}
    assert "sift_kernels_roofline" not in layer
    assert "pose_latency_p95_ms.orb" in layer


def test_config_files_run_as_configs():
    from visualslam_tpu_torch.utils.config import FAST_CONFIG, SlamConfig

    fast = spec.find_cell("kitti-fast.drive").config
    assert SlamConfig.from_dict(fast["slam"]) == FAST_CONFIG
    orb = SlamConfig.from_dict(spec.find_cell("kitti-orb.drive")
                               .config["slam"])
    assert orb == FAST_CONFIG.replace(
        frontend="orb", match=FAST_CONFIG.match.replace(metric="hamming"))


def test_unknown_cell():
    with pytest.raises(KeyError):
        spec.find_cell("no-such.cell")


def test_a_new_mix_and_metric_are_files_and_entries(tmp_path):
    """A dummy mix and a dummy metric in a copy of the layout: found by
    name, with no code changed."""
    here = tmp_path / "portbench"
    shutil.copytree(spec.HERE / "configs", here / "configs")
    shutil.copytree(spec.HERE / "traffic", here / "traffic")
    shutil.copytree(spec.HERE / "metrics", here / "metrics")
    shutil.copytree(spec.HERE / "limits", here / "limits")
    shutil.copy(here / "limits" / "kitti-fast.drive.json",
                here / "limits" / "kitti-fast.short-drive.json")
    mix = json.loads((here / "traffic" / "drive.json").read_text())
    mix.update(frames=120, batch=8)
    (here / "traffic" / "short-drive.json").write_text(json.dumps(mix))
    (here / "metrics" / "syncs_max.py").write_text(
        "def read(rec):\n    return max(rec['syncs'], default=None)\n")
    bench = spec.benchmark()
    bench["workloads"].append({"name": "kitti-fast.short-drive",
                               "config": "kitti-fast",
                               "traffic": "short-drive", "chips": 1,
                               "why": "a dummy"})
    bench["per_layer"].append({"name": "syncs_max", "unit": "syncs",
                               "better": "lower",
                               "source": "program_counter",
                               "layer": "tracker stream",
                               "moves": "frames_per_s",
                               "workloads": ["kitti-fast.short-drive"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.find_cell("kitti-fast.short-drive", tmp_path, here)
    assert Traffic.from_dict(cell.traffic).batch == 8
    rec = {"stage_totals": {}, "stage_counts": {}, "syncs": [3, 7],
           "global_ba_s": [], "frontend_ms": [], "slice": None}
    got = spec.read_metrics(cell, rec, here)
    assert got == {"syncs_max": {"value": 7, "unit": "syncs"},
                   "host_syncs_per_batch": {"value": 5.0,
                                            "unit": "syncs/batch"}}
    assert "syncs_max" not in {
        m["name"] for m in spec.find_cell("kitti-fast.drive", tmp_path,
                                          here).per_layer}

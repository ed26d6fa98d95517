"""A whole run on the CPU at a small size (the card's look skipped): the
result's line, and the check coming out false with the timed path broken
underneath it, once for each fault a cell of one card can have."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from portbench import faults, spec
from portbench.drive import Traffic
from portbench.run import run_cell
from portbench.tests.conftest import ROOT

SEED = 2 ** 31 + 4242
WORLD = {"scene_seed": 0, "h": 120, "w": 376, "n_dots": 1500, "step": 0.4}
TRAFFIC = Traffic.from_dict({
    "frames": 24, "frames_per_lap": 80, "init": 8, "batch": 8,
    "global_ba": False, "warm_drives": 1,
    "profile": {"first_batch": 0, "batches": 1}, "check": {"batches": 1}})


def run(limits=None, trace=False):
    cell = spec.find_cell("kitti-fast.drive")
    # seconds 0: the first drive, which always runs to its end, alone
    return run_cell(cell, SEED, 0.0, trace, device="cpu",
                    t0=time.perf_counter(), world_kw=WORLD,
                    traffic=TRAFFIC, limits=limits, frame_cache=None)


@pytest.fixture(scope="module")
def sound():
    return run()


@pytest.fixture(scope="module")
def limits(sound):
    """Limits that the sound run meets with room: the faults have to
    move a number well past what a sound run reads."""
    got = {k: v["value"] for k, v in sound["compared"].items()}
    return {k: 0.0 if k == "undelivered" else 2.0 * v + 1e-3
            for k, v in got.items()}


def test_result_line(sound):
    assert list(sound)[-1] == "compared"
    assert set(sound) >= {"correct", "attempted", "failed", "metrics",
                          "device"}
    assert sound["attempted"] == 24 and sound["failed"] == 0
    assert set(sound["metrics"]) == {"frames_per_s", "pose_latency_p95_ms",
                                     "device_mem_peak_gib", "setup_s"}
    assert all(v["value"] > 0 for k, v in sound["metrics"].items()
               if k != "device_mem_peak_gib")
    assert set(sound["compared"]) == set(
        spec.find_cell("kitti-fast.drive").limits)
    # the CPU path is the port's plain path, which the judge finds sound
    assert sound["compared"]["sift.not_kp"]["value"] == 0.0
    assert sound["compared"]["sift.desc_miss"]["value"] < 0.01
    assert 0.0 < sound["compared"]["ate_share.delivered"]["value"] < 0.2
    json.dumps(sound)


def test_traced_line():
    got = run(trace=True)
    assert "engine_ms_per_batch" in got["metrics"]
    assert set(got["metrics"]) <= {
        m["name"] for m in spec.find_cell("kitti-fast.drive").per_layer}


def test_sound_run_meets_its_limits(sound, limits):
    assert run(limits)["correct"]


@pytest.mark.parametrize("fault, number", [
    ("state_unchanged", "ate_share.delivered"),
    ("half_batch", "undelivered"),
    ("answer_altered", "sift.desc_miss")])
def test_fault_fails_the_check(limits, fault, number):
    with faults.FAULTS[fault]():
        got = run(limits)
    assert not got["correct"]
    c = got["compared"][number]
    assert c["value"] > c["limit"]


def _main(cwd, *args):
    return subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload",
         "kitti-fast.drive", "--seed", str(2 ** 31 + 1), "--seconds", "1",
         *args], cwd=cwd, capture_output=True, text=True)


def test_no_card_no_result():
    assert not torch.cuda.is_available()
    out = _main(ROOT)
    assert out.returncode == 3 and out.stdout == ""


def test_no_program_no_result(tmp_path):
    """A directory that holds only BENCHMARK.json and the benchmark."""
    shutil.copy(f"{ROOT}/BENCHMARK.json", tmp_path)
    shutil.copytree(f"{ROOT}/portbench", tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "_cache"))
    out = _main(tmp_path)
    assert out.returncode != 0 and out.stdout == ""


def test_unknown_cell_no_result():
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", "no.such",
         "--seed", "1", "--seconds", "1"], cwd=ROOT, capture_output=True,
        text=True)
    assert out.returncode == 2 and out.stdout == ""

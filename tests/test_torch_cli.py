"""The port's CLI (python -m visualslam_tpu_torch.cli) on the CPU: run +
eval, checkpoints and resume, global BA, detect with each frontend, the
subcommands that raise without a card, the accuracy table (a
reference-profile row included), two-view, the overlays and the debug
helpers. The runs use FAST_CONFIG with its keypoint capacities cut to
256 / 128 per octave and 120x160 frames (FAST_CONFIG's own capacities
cost the CPU ~4 s a frame in the plain patch path); the accuracy table's
reference row DEFAULT_CONFIG cut to 3 octaves and the same capacities."""

import contextlib
import io
import json
import os

import numpy as np
import pytest
import torch

from visualslam_tpu.cli import main as jmain
from visualslam_tpu_torch.cli import main
from visualslam_tpu_torch.utils import config

SMALL = config.FAST_CONFIG.replace(sift=config.FAST_CONFIG.sift.replace(
    max_keypoints=256, max_keypoints_per_octave=128))
SMALL_REFERENCE = config.DEFAULT_CONFIG.replace(
    pyramid=config.DEFAULT_CONFIG.pyramid.replace(num_octaves=3),
    sift=config.DEFAULT_CONFIG.sift.replace(max_keypoints=256,
                                            max_keypoints_per_octave=128))
WORLD = ["--height", "120", "--width", "160", "--dots", "400"]


@pytest.fixture(autouse=True, scope="module")
def _small_config_one_thread():
    """The small FAST_CONFIG for every subcommand (they read
    utils.config.FAST_CONFIG when called), and one intra-op thread (the
    suite runs files in parallel worker processes)."""
    mp = pytest.MonkeyPatch()
    mp.setattr(config, "FAST_CONFIG", SMALL)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
    mp.undo()


def _run(argv, fn=main) -> str:
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        fn(argv)
    return buf.getvalue()


@pytest.fixture(scope="module")
def ran(tmp_path_factory):
    """One run: 10 frames in batches of 4 with --global-ba,
    --checkpoint-every 4 and --metrics (the warmup tracker included)."""
    d = tmp_path_factory.mktemp("run")
    cwd = os.getcwd()
    os.chdir(d)
    try:
        out = _run(["run", "--synthetic", "10", "--batch", "4",
                    "--device", "cpu", "--global-ba", "--checkpoint-every",
                    "4", "--out", "est.txt", "--metrics", "m.jsonl",
                    *WORLD])
    finally:
        os.chdir(cwd)
    return d, out


def test_cli_run_and_eval_roundtrip(ran):
    d, out = ran
    rows = [json.loads(line) for line in open(d / "m.jsonl")]
    assert [r["frame"] for r in rows] == list(range(10))
    est = str(d / "est.txt")
    assert np.loadtxt(est).shape == (10, 12)
    assert "ATE (Sim3-aligned)" in out and os.path.exists(
        d / "trajectory.png")
    res = json.loads(_run(["eval", est, est]).strip().splitlines()[-1])
    assert res["ate_m"] < 1e-9 and res["frames"] == 10
    # eval against the ground truth agrees with the JAX package's eval
    from visualslam_tpu_torch.io.serialization import save_kitti_poses
    from visualslam_tpu_torch.io.synthetic import SyntheticSequence

    gt = str(d / "gt.txt")
    save_kitti_poses(gt, SyntheticSequence(num_frames=10, h=120, w=160,
                                           n_dots=400).gt_poses)
    got = json.loads(_run(["eval", est, gt]).strip().splitlines()[-1])
    want = json.loads(_run(["eval", est, gt], jmain).strip().splitlines()[-1])
    assert got["frames"] == want["frames"] == 10
    for k in ("ate_m", "rpe_trans_m", "rpe_rot_deg"):
        assert got[k] == pytest.approx(want[k], rel=1e-9, abs=1e-12), k
    assert got["ate_m"] < 0.5


def test_cli_global_ba_and_checkpoint(ran):
    d, out = ran
    line = next(x for x in out.splitlines() if x.startswith("global BA:"))
    c0, c1 = (float(v) for v in line.split("cost ")[1].split(" -> "))
    assert c1 < c0
    z = np.load(d / "slam_ckpt.npz")
    assert len(z["frames"]) == 10           # saved after the last batch
    assert any(k.startswith("eng_") for k in z.files)


def test_cli_resume_continues_from_the_checkpoint(ran, tmp_path,
                                                   monkeypatch):
    d, _ = ran
    monkeypatch.chdir(tmp_path)
    out = _run(["run", "--synthetic", "14", "--batch", "4", "--device",
                "cpu", "--resume", str(d / "slam_ckpt.npz"), "--no-prewarm",
                "--out", "est.txt", *WORLD])
    assert "at frame 10" in out
    rows = [json.loads(line) for line in open("metrics.jsonl")]  # default
    assert [r["frame"] for r in rows] == list(range(14))
    assert np.loadtxt("est.txt").shape == (14, 12)
    assert all(r["tracking_ok"] for r in rows[10:])


def test_cli_without_a_card_raises(tmp_path, monkeypatch):
    """The card is the default device: without one, run and benchmark
    raise and never fall back to the CPU."""
    monkeypatch.chdir(tmp_path)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError):
            main(["run", "--synthetic", "4", "--no-prewarm", *WORLD])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["benchmark"])


def test_cli_run_pipeline(tmp_path, monkeypatch):
    """run --pipeline: the stage-overlapped loop (detection of batch k+1
    dispatched before batch k is tracked) writes every frame's pose and
    metrics, and the trajectory tracks the ground truth."""
    monkeypatch.chdir(tmp_path)
    out = _run(["run", "--synthetic", "10", "--batch", "4", "--device",
                "cpu", "--pipeline", "--no-prewarm", "--out", "est.txt",
                *WORLD])
    rows = [json.loads(line) for line in open("metrics.jsonl")]
    assert [r["frame"] for r in rows] == list(range(10))
    assert np.loadtxt("est.txt").shape == (10, 12)
    ate = float(out.split("ATE (Sim3-aligned):")[1].split()[0])
    assert ate < 0.5, out


def test_cli_accuracy_writes_its_own_table(tmp_path, monkeypatch):
    """accuracy with SCENARIOS replaced by one tiny run per profile and the
    photographic row: ACCURACY_TORCH.md with two measured rows (the
    reference profile at DEFAULT_CONFIG's 2x upsample, cut to 3 octaves
    and the small capacities) and a "not run" row saying why."""
    from visualslam_tpu_torch import cli

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(config, "DEFAULT_CONFIG", SMALL_REFERENCE)
    world = dict(num_frames=10, h=120, w=160, n_dots=400)
    monkeypatch.setattr(cli, "SCENARIOS", [
        ("dolly-10", "fast", world, True, 4),
        ("dolly-10", "reference", world, False, 4),
        ("photo-loop-100", "fast", "photo", False, 8),
    ])
    _run(["accuracy", "--device", "cpu"])
    assert not os.path.exists("ACCURACY.md")
    text = open("ACCURACY_TORCH.md").read()
    rows = [line for line in text.splitlines()
            if line.startswith("| dolly") or line.startswith("| photo")]
    assert len(rows) == 3
    for row, profile in zip(rows[:2], ("fast", "reference")):
        cells = [c.strip() for c in row.strip("|").split("|")]
        assert cells[:2] == ["dolly-10", profile] and cells[3] == "10"
        assert float(cells[6]) < 0.5                      # ATE
        assert "not run" not in row
    assert "not run" in rows[2] and "photograph" in rows[2]


@pytest.mark.parametrize("frontend", ["sift", "orb", "harris"])
def test_cli_detect_each_frontend(tmp_path, monkeypatch, frontend):
    """detect at DEFAULT_CONFIG (the reference profile for SIFT: 2x upsample,
    4 octaves) on a rendered 96x128 frame: keypoints found, the overlay and
    the descriptor file written with one row per keypoint (SIFT's 128
    values, ORB's 8 packed words, Harris's 256 patch values)."""
    from PIL import Image

    from visualslam_tpu_torch.io.serialization import load_descriptors_dat
    from visualslam_tpu_torch.io.synthetic import SyntheticSequence, render_uint8

    monkeypatch.chdir(tmp_path)
    seq = SyntheticSequence(num_frames=1, h=96, w=128, n_dots=500)
    Image.fromarray(render_uint8(seq, [0])[0]).save("img.png")
    out = _run(["detect", "img.png", "--frontend", frontend, "--device",
                "cpu"])
    n = int(out.split("detected ")[1].split()[0])
    assert n > 20 and f"({frontend})" in out
    assert os.path.getsize("img_keypoints.png") > 100
    desc = load_descriptors_dat("img_descriptors.dat")
    width = {"sift": 128, "orb": 8, "harris": 256}[frontend]
    assert desc.shape == (n, width)


def test_cli_two_view(tmp_path, monkeypatch):
    from PIL import Image

    from visualslam_tpu_torch.io.synthetic import SyntheticSequence, render_uint8

    monkeypatch.chdir(tmp_path)
    seq = SyntheticSequence(num_frames=6, h=120, w=160, n_dots=400)
    f = render_uint8(seq, [0, 5])
    Image.fromarray(f[0]).save("a.png")
    Image.fromarray(f[1]).save("b.png")
    out = _run(["two-view", "a.png", "b.png", "--fx", str(0.6 * 160),
                "--device", "cpu"])
    n_inl = int(out.split("inliers: ")[1].split()[0])
    assert n_inl > 20
    assert os.path.getsize("two_view_matches.png") > 100


def test_viz_outputs(tmp_path, rng):
    """tests/test_cli.py's overlays on the port's Features, plus the match
    overlay and the pyramid montage."""
    from visualslam_tpu_torch.models.pyramid import build_pyramid
    from visualslam_tpu_torch.models.types import Features, Keypoints, Matches
    from visualslam_tpu_torch.slam.viz import (
        draw_keypoints,
        draw_matches,
        draw_trajectory,
        save_pyramid_montage,
    )

    img = rng.random((64, 64)).astype(np.float32)
    k = 16
    kps = Keypoints.empty(k)._replace(
        yx=torch.from_numpy(rng.uniform(5, 59, (k, 2)).astype(np.float32)),
        sigma=torch.ones(k), valid=torch.ones(k, dtype=torch.bool))
    feats = Features(kps, torch.zeros(k, 8))
    p1 = str(tmp_path / "kp.png")
    draw_keypoints(img, feats, p1)
    assert os.path.getsize(p1) > 100
    m = Matches(idx_a=torch.arange(k, dtype=torch.int32),
                idx_b=torch.arange(k, dtype=torch.int32),
                distance=torch.zeros(k), valid=torch.ones(k, dtype=torch.bool))
    p3 = str(tmp_path / "m.png")
    draw_matches(img, img, feats, feats, m, p3)
    assert os.path.getsize(p3) > 100
    ss = build_pyramid(torch.from_numpy(img)[None], SMALL.pyramid)
    p4 = str(tmp_path / "pyr.png")
    save_pyramid_montage(ss, p4)
    assert os.path.getsize(p4) > 100

    poses = np.tile(np.eye(3, 4, dtype=np.float64), (5, 1, 1))
    poses[:, 0, 3] = np.arange(5)
    p2 = str(tmp_path / "traj.png")
    draw_trajectory(poses, p2, gt=poses)
    assert os.path.getsize(p2) > 100


def test_debug_checked_catches_nan():
    """tests/test_utils.py's contract: checked(fn)(x) returns (err, out)
    and err.throw() raises on a NaN output; a finite one passes."""
    from visualslam_tpu_torch.utils.debug import checked, debug_mode

    err, out = checked(torch.log)(torch.tensor(-1.0))
    assert torch.isnan(out)
    with pytest.raises(Exception):
        err.throw()
    err, out = checked(lambda x: (x + 1, {"y": x * 2}))(torch.ones(3))
    assert err.get() is None
    err.throw()
    err, _ = checked(lambda x: (x, x / 0))(torch.ones(2))
    assert "output 1" in err.get()
    with debug_mode():
        assert torch.is_anomaly_enabled()
    assert not torch.is_anomaly_enabled()

"""The port's accuracy table: `cli accuracy` on the CPU with a tiny
scenario and a KITTI-scale artifact (the row the JAX command appends, with
its columns), and the committed ACCURACY_TORCH.md held, row by row, to the
JAX package's ACCURACY.md:

  - keyframes and mean inliers within half / twice of the JAX row;
  - ATE at most twice the JAX row's;
  - at least one loop closure on loop-96 and bench-loop-256;
  - the KITTI-scale row: keyframes within half / twice of the JAX row's,
    at least one closure, ATE after global BA at most twice the JAX row's.

A row whose note marks a miss fails; photo-loop-100 alone may read "not
run" (the reference's photograph is not in the repository). The band
tests skip while ACCURACY_TORCH.md is absent."""

import contextlib
import io
import json
import os

import pytest
import torch

from visualslam_tpu_torch import cli
from visualslam_tpu_torch.utils import config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_TABLE = os.path.join(ROOT, "ACCURACY_TORCH.md")
JAX_TABLE = os.path.join(ROOT, "ACCURACY.md")
KITTI = "kitti-500 (end-to-end+gba)"
LOOPS = ("loop-96", "bench-loop-256")
SMALL = config.FAST_CONFIG.replace(sift=config.FAST_CONFIG.sift.replace(
    max_keypoints=256, max_keypoints_per_octave=128))
KS_FIXTURE = {
    "device": "NVIDIA H100 80GB HBM3, 700.00 W", "frames": 500,
    "image": "376x1248", "profile": "fast", "batch": 16,
    "sequence_fps": 8.58, "track_wall_s": 57.34, "keyframes": 67,
    "loop_closures": 2, "relocalizations": 0, "landmarks_live": 1324,
    "mean_inliers": 280.0, "ate_tracked_m": 4.7334,
    "global_ba": {"solver": "schur_mf", "cameras": 67},
    "ate_after_gba_m": 4.7169, "rpe_trans_m": 0.3872, "rpe_rot_deg": 0.2584,
}


def parse_table(path: str) -> tuple:
    """(column names, [row dicts]) of a markdown accuracy table."""
    lines = [ln for ln in open(path).read().splitlines()
             if ln.startswith("|")]
    cols = [c.strip() for c in lines[0].strip("|").split("|")]
    rows = [dict(zip(cols, (c.strip() for c in ln.strip("|").split("|"))))
            for ln in lines[2:]]
    return cols, rows


def _key(row) -> tuple:
    return row["scenario"], row["profile"], row["batch"]


def test_cli_accuracy_appends_the_kitti_scale_row(tmp_path, monkeypatch):
    """One tiny scenario on the CPU and a KITTI-scale artifact: the table
    has the JAX table's columns (and a note), the device line, the
    scenario's row, and the KITTI-scale row with the values the JAX
    command takes from its artifact (visualslam_tpu/cli.py)."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(config, "FAST_CONFIG", SMALL)
    monkeypatch.setattr(cli, "SCENARIOS", [
        ("dolly-10", "fast", dict(num_frames=10, h=120, w=160, n_dots=400),
         False, 4)])
    ks = tmp_path / "ks.json"
    ks.write_text(json.dumps(KS_FIXTURE))
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            cli.main(["accuracy", "--device", "cpu", "--kitti-scale",
                      str(ks), "--commit", "abc1234"])
    finally:
        torch.set_num_threads(n)
    text = open("ACCURACY_TORCH.md").read()
    assert "Device: cpu." in text
    cols, rows = parse_table("ACCURACY_TORCH.md")
    jcols, _ = parse_table(JAX_TABLE)
    assert cols == jcols + ["note"]
    assert [r["scenario"] for r in rows] == ["dolly-10", KITTI]
    assert rows[0]["commit"] == "abc1234" and rows[0]["note"] == ""
    assert float(rows[0]["ate_m"]) < 0.5
    k = KS_FIXTURE
    want = {"scenario": KITTI, "profile": k["profile"], "commit": "see json",
            "frames": k["frames"], "batch": k["batch"],
            "fps": k["sequence_fps"], "ate_m": k["ate_after_gba_m"],
            "rpe_trans_m": k["rpe_trans_m"], "rpe_rot_deg": k["rpe_rot_deg"],
            "mean_inliers": k["mean_inliers"], "min_inliers": "-",
            "keyframes": k["keyframes"], "loop_closures": k["loop_closures"]}
    assert {c: rows[1][c] for c in jcols} == {c: str(v)
                                              for c, v in want.items()}
    assert k["device"] in rows[1]["note"]


def _port_rows() -> dict:
    if not os.path.exists(PORT_TABLE):
        pytest.skip("ACCURACY_TORCH.md is absent (python -m "
                    "visualslam_tpu_torch.cli accuracy writes it on the card)")
    return {_key(r): r for r in parse_table(PORT_TABLE)[1]}


ROWS = [(name, profile, str(batch))
        for name, profile, _, _, batch in cli.SCENARIOS] + [
    (KITTI, "fast", "16")]


@pytest.mark.parametrize("key", ROWS, ids=["-".join(k) for k in ROWS])
def test_committed_table_row_within_the_bands(key):
    port = _port_rows()
    jax = {_key(r): r for r in parse_table(JAX_TABLE)[1]}
    assert key in port, f"{key} missing from ACCURACY_TORCH.md"
    p, j = port[key], jax[key]
    note = p["note"]
    if note.startswith("not run"):
        assert key[0] == "photo-loop-100", note
        return
    assert note == "" or note.startswith("from "), f"marked: {note}"
    assert float(p["fps"]) > 0
    kf_p, kf_j = int(p["keyframes"]), int(j["keyframes"])
    assert kf_j / 2 <= kf_p <= 2 * kf_j, (kf_p, kf_j)
    inl_p, inl_j = float(p["mean_inliers"]), float(j["mean_inliers"])
    assert inl_j / 2 <= inl_p <= 2 * inl_j, (inl_p, inl_j)
    assert float(p["ate_m"]) <= 2 * float(j["ate_m"]), (p["ate_m"],
                                                        j["ate_m"])
    if key[0] in LOOPS or key[0] == KITTI:
        assert int(p["loop_closures"]) >= 1

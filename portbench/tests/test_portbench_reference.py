"""The plain reference: the judge finds the port's plain path sound at a
small size and sees what a broken output changes; its pieces follow
their definitions; the trajectory error ignores a similarity."""

import json
import math

import numpy as np
import pytest
import torch

from portbench import check, faults
from portbench.drive import Sequence, Traffic
from portbench.reference import ate, frontend, orb, sift
from portbench.world import World


def _frames(n=2, seed=5):
    return World(seed, 120, 376, 1500, 0.4, 40).render(range(n), "cpu")


def _cfg(name):
    from visualslam_tpu_torch.utils.config import FAST_CONFIG

    cfg = FAST_CONFIG
    if name == "orb":
        cfg = cfg.replace(frontend="orb",
                          match=cfg.match.replace(metric="hamming"))
    return cfg


def _program(name, n=2):
    from visualslam_tpu_torch.frontend import make_frontend
    from visualslam_tpu_torch.ops.cuda import PLAIN

    cfg = _cfg(name)
    imgs = _frames(n)
    return imgs, make_frontend(cfg, PLAIN)(imgs), json.loads(cfg.to_json())


@pytest.mark.parametrize("name", ["sift", "orb"])
def test_the_ports_plain_path_is_judged_sound(name):
    imgs, feats, cfg = _program(name)
    assert int(feats.keypoints.valid.sum()) > 400
    got = frontend.numbers(imgs, feats, cfg)
    if name == "sift":
        assert got["sift.not_kp"] == 0.0 and got["sift.ori_miss"] == 0.0
        assert got["sift.pos_miss"] < 0.01 and got["sift.desc_miss"] < 0.01
    else:
        assert got["orb.not_kp"] == 0.0 and got["orb.angle_miss"] == 0.0
        assert got["orb.bit_share"] == 0.0


def test_the_judge_sees_a_broken_sift_output():
    imgs, feats, cfg = _program("sift", 1)
    kp = feats.keypoints
    first = torch.arange(kp.valid.shape[1])[None, :] < 20

    def judged(**fields):
        f = feats._replace(keypoints=kp._replace(**fields))
        return frontend.numbers(imgs, f, cfg)

    moved = judged(yx_oct=kp.yx_oct + torch.where(first[..., None], 0.3, 0.0))
    assert moved["sift.pos_miss"] + moved["sift.not_kp"] >= 19 / int(
        kp.valid.sum())
    turned = judged(orientation=(kp.orientation + 3.0) % 360)
    assert turned["sift.ori_miss"] > 0.9 and turned["sift.desc_miss"] > 0.5
    got = frontend.numbers(imgs, faults.alter(feats), cfg)
    assert got["sift.desc_gap"] > 0.1 and got["sift.desc_miss"] > 0.9


def test_the_judge_sees_a_broken_orb_output():
    imgs, feats, cfg = _program("orb", 1)
    got = frontend.numbers(imgs, faults.alter(feats), cfg)
    n = int(feats.keypoints.valid.sum())
    assert got["orb.bit_share"] == pytest.approx(2 / 32)
    kp = feats.keypoints
    shifted = feats._replace(keypoints=kp._replace(yx_oct=kp.yx_oct + 1.0))
    assert frontend.numbers(imgs, shifted, cfg)["orb.not_kp"] > 0.5
    turned = feats._replace(keypoints=kp._replace(
        orientation=(kp.orientation + 10.0) % 360))
    got = frontend.numbers(imgs, turned, cfg)
    assert got["orb.angle_gap"] == pytest.approx(10.0, abs=1e-3)
    assert got["orb.angle_miss"] == 1.0
    assert got["orb.bit_share"] > 0.01


def test_blur_and_resize_follow_their_definitions():
    img = torch.from_numpy(np.random.default_rng(1).random((9, 13)))
    sigma = 1.3
    k = sift.gaussian_taps(sigma, 4.0)
    r = (len(k) - 1) // 2
    assert r == math.ceil(4 * sigma) and k.sum() == pytest.approx(1.0)
    pad = np.pad(img.numpy(), r, mode="symmetric")
    want = np.zeros((9, 13))
    for i in range(9):
        for j in range(13):
            win = pad[i:i + 2 * r + 1, j:j + 2 * r + 1]
            want[i, j] = k @ win @ k
    prec = sift.Precision(torch.float64, False, None)
    assert np.allclose(sift.blur(img, sigma, 4.0, prec).numpy(), want,
                       atol=1e-12)
    w = orb.resize_weights(100, 83)
    assert np.allclose(w.sum(0), 1.0) and (w >= 0).all()
    flat = torch.ones(100, 100, dtype=torch.float64)
    assert torch.allclose(orb.level_image(flat, 83, 83, False),
                          torch.ones(83, 83, dtype=torch.float64))


def test_ate_ignores_a_similarity():
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(size=(50, 3)), axis=0)
    c, s = np.cos(0.3), np.sin(0.3)
    R = np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]])
    est = 2.5 * gt @ R.T + np.array([1.0, -2.0, 3.0])
    assert ate.ate_rmse(est, gt) == pytest.approx(0.0, abs=1e-9)
    noisy = est + rng.normal(scale=0.1, size=est.shape)
    assert 0.01 < ate.ate_rmse(noisy, gt) < 0.1


def test_direction_error():
    gt = np.cumsum(np.tile([[0.0, 0.0, 0.4]], (40, 1)), axis=0)
    gt[20:, 0] = np.arange(20) * 0.2
    ids = np.arange(40)
    assert check.dir_err_deg(ids, 3.0 * gt, gt, 8) == pytest.approx(0.0)
    still = np.repeat(gt[:1], 40, axis=0)
    assert check.dir_err_deg(ids, still, gt, 8) == 180.0
    flipped = gt * np.array([-1.0, 1.0, 1.0])
    assert 0.0 < check.dir_err_deg(ids, flipped, gt, 8) < 90.0
    assert check.dir_err_deg(ids[::2], gt[::2], gt[::2], 8) == (
        pytest.approx(0.0))


def test_the_check_of_a_sequence():
    from visualslam_tpu_torch.frontend import make_frontend
    from visualslam_tpu_torch.ops.cuda import PLAIN

    traffic = Traffic.from_dict({
        "frames": 40, "frames_per_lap": 40, "init": 8, "batch": 8,
        "global_ba": False, "warm_drives": 1,
        "profile": {"first_batch": 1, "batches": 1},
        "check": {"batches": 2}})
    seq = Sequence(_frames(40).numpy(), traffic)
    assert [k for k, _ in seq.batches] == [8, 16, 24, 32]
    cfg = _cfg("sift")
    pos = check.sample_batches(3, len(seq.batches), 2)
    fe = make_frontend(cfg, PLAIN)
    caps = {("first", i): fe(torch.from_numpy(seq.batches[i][1]))
            for i in pos}
    got = check.frontend_numbers(seq, caps, json.loads(cfg.to_json()),
                                 "cpu")
    assert got["sift.not_kp"] == 0.0 and got["sift.desc_miss"] < 0.01
    assert set(got) == {"sift.not_kp", "sift.pos_gap", "sift.pos_miss",
                        "sift.ori_miss", "sift.desc_gap", "sift.desc_miss"}
    ok, rows = check.verdict({"a": 0.1, "b": 0.0, "c": 9.0},
                             {"a": 0.2, "b": 0.0})
    assert ok and rows == [("a", 0.1, 0.2), ("b", 0.0, 0.0)]
    assert not check.verdict({"a": 0.3}, {"a": 0.2})[0]
    assert not check.verdict({"a": float("nan")}, {"a": 0.2})[0]
    assert not check.verdict({}, {"a": 0.2})[0]

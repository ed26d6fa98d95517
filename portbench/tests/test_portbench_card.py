"""On the card: the control (the plain frontend in the precision below
the configuration's, put in the program's place) fails the frontend check
that the program passes, and so does the fault `answer_altered`. Skips
without a card; run on one with

    python3 -m pytest portbench/tests -m gpu
"""

import pytest
import torch

from portbench import spec
from portbench.control import batch_readings, seed_readings
from portbench.drive import Traffic

WORLD = {"scene_seed": 0, "h": 376, "w": 1248, "n_dots": 12000, "step": 0.4}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.gpu
@pytest.mark.parametrize("cell", ["kitti-fast.drive", "kitti-orb.drive"])
def test_control_fails_the_program_passes(card, cell):
    c = spec.find_cell(cell)
    traffic = Traffic.from_dict({**c.traffic, "frames": 56})
    per_batch, _ = batch_readings(c, "cuda", WORLD, traffic)
    for seed in (2 ** 31 + 11, 2 ** 31 + 12, 2 ** 31 + 13):
        got = seed_readings(per_batch, seed, traffic.check_batches)
        limits = {k: v for k, v in c.limits.items() if k in got["program"]}
        assert all(got["program"][k] <= v for k, v in limits.items()), got
        for kind in ("control", "answer_altered"):
            assert any(got[kind][k] > v for k, v in limits.items()), got

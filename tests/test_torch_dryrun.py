"""The port's mesh dry run (parallel/dryrun.py) on a virtual 8-shard CPU
mesh: the data-parallel frontend, the fused track_step, the landmark- and
trajectory-sharded BA and the matrix-free trajectory-sharded BA at
C = 1024, each LM solve lowering its cost (the counterpart of
__graft_entry__.dryrun_multichip on conftest's 8 virtual devices)."""

import numpy as np
import pytest
import torch

from visualslam_tpu_torch.frontend import SiftFrontend
from visualslam_tpu_torch.parallel.dryrun import (
    data_parallel_frontend,
    run_dryrun,
)
from visualslam_tpu_torch.parallel.mesh import make_mesh
from visualslam_tpu_torch.utils.config import DEFAULT_CONFIG

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def test_run_dryrun_8(capsys):
    run_dryrun(8, devices=[CPU] * 8)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 5 and all(x.startswith("[dryrun]") for x in lines)
    assert "total_detections=" in lines[0] and "C=1024" in lines[4]
    for line in lines[2:]:
        c0, c1 = (float(v) for v in line.split("cost ")[1].split(" -> "))
        assert c1 < c0


def test_data_parallel_frontend_equals_one_device_chunks(rng):
    """Each 'data' shard's features equal the one-device frontend on the
    same chunk, and the psum'd count is their total."""
    cfg = DEFAULT_CONFIG.replace(
        pyramid=DEFAULT_CONFIG.pyramid.replace(num_octaves=2,
                                               initial_upsample=False))
    imgs = rng.random((4, 64, 96), dtype=np.float32)
    fe = SiftFrontend(cfg)
    feats, total = data_parallel_frontend(fe, imgs,
                                          make_mesh(2, "data", [CPU] * 2))
    count = 0
    for s in range(2):
        want = fe(torch.from_numpy(imgs[2 * s:2 * s + 2]))
        for a, b in zip(feats[s], want):
            if isinstance(a, torch.Tensor):
                torch.testing.assert_close(a, b, rtol=0, atol=0)
            else:
                for x, y in zip(a, b):
                    torch.testing.assert_close(x, y, rtol=0, atol=0)
        count += int(want.keypoints.valid.sum())
    assert [int(v) for v in total] == [count, count]

"""The port's stage-overlapped pipeline (parallel/pipeline.py), as
tests/test_tracker.py's test_pipelined_equals_sequential_batched: the
pipelined tracker and detect_batch + process_features chunk by chunk give
the same trajectory bit for bit (the same frontend on the same inputs, the
features consumed in the same order; the same chunking on both sides,
since a batch's width changes the banded blur's reduction order)."""

import numpy as np
import pytest
import torch

from test_torch_tracker import RCFG
from visualslam_tpu_torch.io.synthetic import SyntheticSequence
from visualslam_tpu_torch.parallel.pipeline import batched, pipelined_process
from visualslam_tpu_torch.slam.tracker import Tracker


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_batched_covers_the_range():
    assert list(batched(8, 3)) == [(0, [0, 1, 2]), (3, [3, 4, 5]),
                                   (6, [6, 7])]
    assert list(batched(5, 4, start=2)) == [(2, [2, 3, 4])]


def test_pipelined_equals_sequential_batched():
    seq = SyntheticSequence(num_frames=8, h=120, w=160, n_dots=400)
    imgs = np.stack([seq.frame(k) for k in range(len(seq))])

    t1 = Tracker(RCFG, seq.intrinsics, device="cpu")
    for k in range(0, len(imgs), 3):
        fb = t1.detect_batch(imgs[k:k + 3])
        for i in range(len(imgs[k:k + 3])):
            t1.process_features(Tracker.features_at(fb, i), k + i)

    t2 = Tracker(RCFG, seq.intrinsics, device="cpu")
    results = pipelined_process(t2, imgs, batch=3)

    assert [r.frame_id for r in results] == list(range(8))
    assert any(r.is_keyframe for r in results[1:])
    np.testing.assert_array_equal(t1.trajectory(), t2.trajectory())

"""The device renderer against the port's NumPy SyntheticSequence."""

import numpy as np

from portbench.world import World
from visualslam_tpu_torch.io.synthetic import SyntheticSequence


def test_frames_and_poses_equal_the_numpy_sequence():
    seed = 2 ** 31 + 12345
    seq = SyntheticSequence(num_frames=40, h=96, w=312, n_dots=800,
                            seed=seed, step=0.4, trajectory="loop")
    world = World(seed, 96, 312, 800, 0.4, frames_per_lap=40)
    ids = [0, 3, 9, 10, 21, 39]
    got = world.render(ids, "cpu", batch=4).numpy()
    want = np.stack([np.clip(seq.frame(k) * 255.0, 0, 255).astype(np.uint8)
                     for k in ids])
    assert np.array_equal(got, want)
    assert np.array_equal(world.centers(40), seq.gt_poses[:, :, 3])
    assert np.array_equal(seq.gt_poses[:, :, :3],
                          np.broadcast_to(np.eye(3), (40, 3, 3)))
    np.testing.assert_array_equal(world.intrinsics, seq.intrinsics)


def test_later_laps_see_the_first_lap():
    world = World(7, 48, 160, 200, 0.4, frames_per_lap=40)
    c = world.centers(120)
    np.testing.assert_allclose(c[40:80], c[:40], atol=1e-9)
    np.testing.assert_allclose(c[80:], c[:40], atol=1e-9)


def test_same_seed_same_frames():
    a = World(11, 48, 160, 300, 0.4, 40).render(range(4), "cpu").numpy()
    b = World(11, 48, 160, 300, 0.4, 40).render(range(4), "cpu").numpy()
    c = World(12, 48, 160, 300, 0.4, 40).render(range(4), "cpu").numpy()
    assert np.array_equal(a, b)
    assert not np.array_equal(a, c)

"""The port's host IO against the JAX package's: the reference-format
descriptor files, KITTI poses and the KITTI loader, the photographic
sequence (bit for bit), the native decoder, and the image helpers."""

import struct

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.io import native as jnative
from visualslam_tpu.io import serialization as jser
from visualslam_tpu.io.photo_seq import PhotoSequence as JPhotoSequence
from visualslam_tpu.utils import images as jimages
from visualslam_tpu_torch.io import native
from visualslam_tpu_torch.io import serialization as ser
from visualslam_tpu_torch.io.photo_seq import PhotoSequence, exp_so3_f32
from visualslam_tpu_torch.utils import images


def test_descriptor_dat_roundtrip_and_cross_package(tmp_path, rng):
    d = rng.random((37, 128)).astype(np.float32)
    p = str(tmp_path / "desc.dat")
    ser.save_descriptors_dat(p, d)
    raw = np.fromfile(p, np.int32, count=3)
    assert list(raw) == [37, 128, 4]
    np.testing.assert_array_equal(ser.load_descriptors_dat(p), d)
    np.testing.assert_array_equal(jser.load_descriptors_dat(p), d)
    q = str(tmp_path / "jax.dat")
    jser.save_descriptors_dat(q, d)
    assert open(p, "rb").read() == open(q, "rb").read()


def test_descriptor_dat_accepts_reference_quirk(tmp_path, rng):
    """The reference writes frontSize = sizeof(std::vector<float>) = 24;
    other values are refused."""
    d = rng.random((3, 128)).astype(np.float32)
    p = str(tmp_path / "ref.dat")
    with open(p, "wb") as f:
        f.write(struct.pack("<iii", 3, 128, 24))
        f.write(d.tobytes())
    np.testing.assert_array_equal(ser.load_descriptors_dat(p), d)
    with open(p, "r+b") as f:
        f.write(struct.pack("<iii", 3, 128, 8))
    with pytest.raises(ValueError, match="frontSize"):
        ser.load_descriptors_dat(p)


def test_kitti_poses_roundtrip(tmp_path, rng):
    poses = rng.random((11, 3, 4))
    p = str(tmp_path / "poses.txt")
    ser.save_kitti_poses(p, poses)
    back = ser.load_kitti_poses(p)
    assert back.dtype == np.float64
    np.testing.assert_allclose(back, poses, rtol=1e-6)
    np.testing.assert_array_equal(back, jser.load_kitti_poses(p))
    q = str(tmp_path / "jax.txt")
    jser.save_kitti_poses(q, poses)
    assert open(p).read() == open(q).read()


def _kitti_tree(root, rng, H=48, W=64, n=4):
    from PIL import Image

    seqdir = root / "sequences" / "07"
    imgdir = seqdir / "image_0"
    imgdir.mkdir(parents=True)
    for i in range(n):
        arr = (rng.random((H, W)) * 255).astype(np.uint8)
        Image.fromarray(arr).save(imgdir / f"{i:06d}.png")
    P = "7.070912e+02 0.000000e+00 6.018873e+02 0.000000e+00 " \
        "0.000000e+00 7.070912e+02 1.831104e+02 0.000000e+00 " \
        "0.000000e+00 0.000000e+00 1.000000e+00 0.000000e+00"
    with open(seqdir / "calib.txt", "w") as f:
        for k in range(4):
            f.write(f"P{k}: {P}\n")
    np.savetxt(seqdir / "times.txt", np.arange(n) * 0.1)
    (root / "poses").mkdir()
    poses = np.tile(np.eye(3, 4), (n, 1, 1))
    poses[:, 2, 3] = np.arange(n) * 0.8
    ser.save_kitti_poses(str(root / "poses" / "07.txt"), poses)


def test_kitti_loader_layout(tmp_path, rng):
    """tests/test_io.py's layout test on the port's loader, and the JAX
    package's loader on the same tree gives the same sequence."""
    from visualslam_tpu.io.kitti import KittiOdometrySequence as JKitti
    from visualslam_tpu_torch.io.kitti import (
        KittiOdometrySequence,
        SequenceInfo,
        SyntheticSequence,
    )
    from visualslam_tpu_torch.io import synthetic

    assert SequenceInfo is synthetic.SequenceInfo
    assert SyntheticSequence is synthetic.SyntheticSequence
    _kitti_tree(tmp_path, rng)
    seq = KittiOdometrySequence(str(tmp_path), "07")
    assert len(seq) == 4
    info = seq.info()
    np.testing.assert_allclose(info.intrinsics,
                               [707.0912, 707.0912, 601.8873, 183.1104],
                               rtol=1e-6)
    assert info.image_size == (48, 64)
    np.testing.assert_allclose(info.gt_poses[:, 2, 3], np.arange(4) * 0.8)
    frames = list(seq.frames())
    assert len(frames) == 4 and frames[0].shape == (48, 64)
    np.testing.assert_allclose(frames[1], seq.frame(1), atol=1e-6)

    ref = JKitti(str(tmp_path), "07")
    jinfo = ref.info()
    np.testing.assert_array_equal(info.intrinsics, jinfo.intrinsics)
    np.testing.assert_array_equal(info.gt_poses, jinfo.gt_poses)
    np.testing.assert_array_equal(info.times, jinfo.times)
    for k in range(4):
        np.testing.assert_array_equal(seq.frame(k), ref.frame(k))


def test_exp_so3_f32_is_the_jax_rotation():
    """The photographic path's rotations: bit for bit the JAX package's
    float32 exp_so3, over the angles of a 400-frame path and a few axes
    (the small-angle series included)."""
    from visualslam_tpu.geometry import se3

    ws = [[0.0, np.radians(0.06 * k), 0.0] for k in range(400)]
    ws += [[1e-5, 0.0, 2e-5], [0.3, -0.2, 0.1], [0.0, 0.0, 0.0]]
    for w in ws:
        want = np.asarray(se3.exp_so3(jnp.asarray(w)))
        np.testing.assert_array_equal(exp_so3_f32(w), want, err_msg=str(w))


@pytest.mark.parametrize("trajectory", ["loop", "sweep"])
def test_photo_sequence_equals_jax_bit_for_bit(rng, trajectory):
    img = rng.random((48, 64)).astype(np.float32)
    a = PhotoSequence(img, num_frames=9, trajectory=trajectory)
    b = JPhotoSequence(img, num_frames=9, trajectory=trajectory)
    np.testing.assert_array_equal(a.intrinsics, b.intrinsics)
    np.testing.assert_array_equal(a.gt_poses(), b.gt_poses())
    assert len(a) == len(b) == 9
    for k in range(9):
        fa, fb = a.frame(k), b.frame(k)
        assert fa.dtype == fb.dtype == np.float32
        np.testing.assert_array_equal(fa, fb, err_msg=f"frame {k}")


def _both_native():
    """Skip only when neither package can build the native library (no
    compiler or no libpng / libjpeg headers); else both must have it.
    Decided in the test: the build runs at first use, not at import."""
    if not (native.available() or jnative.available()):
        pytest.skip("neither package could build the native library")
    assert native.available() and jnative.available()


def test_native_decoder_matches_jax(tmp_path, rng):
    """The port's build of native/vstpu_io.cpp decodes PNG and PGM as the
    JAX package's does (and as PIL does), into the port's build folder."""
    from PIL import Image

    _both_native()
    assert native.library_path().parent.name == "_build"
    data = (rng.random((10, 12)) * 255).astype(np.uint8)
    png = tmp_path / "t.png"
    Image.fromarray(data).save(png)
    pgm = tmp_path / "t.pgm"
    with open(pgm, "wb") as f:
        f.write(b"P5 12 10 255\n")
        f.write(data.tobytes())
    for p in (png, pgm):
        got = native.decode_gray(str(p))
        np.testing.assert_array_equal(got, jnative.decode_gray(str(p)))
        np.testing.assert_allclose(got, data / 255.0, atol=1e-6)
    pf = native.Prefetcher([str(png), str(pgm)] * 2, capacity=2,
                           n_threads=2)
    frames = list(pf)
    pf.close()
    assert len(frames) == 4
    np.testing.assert_array_equal(frames[2], frames[0])


def test_native_descriptor_files_cross_language(tmp_path, rng):
    _both_native()
    d = rng.random((5, 128)).astype(np.float32)
    p = str(tmp_path / "c.dat")
    native.write_descriptors(p, d)
    np.testing.assert_array_equal(ser.load_descriptors_dat(p), d)
    q = str(tmp_path / "py.dat")
    ser.save_descriptors_dat(q, d)
    np.testing.assert_array_equal(native.read_descriptors(q), d)


def test_image_helpers_match_jax(tmp_path, rng):
    from PIL import Image

    data = (rng.random((20, 30)) * 255).astype(np.uint8)
    p = str(tmp_path / "g.png")
    Image.fromarray(data).save(p)
    np.testing.assert_array_equal(images.load_gray(p), jimages.load_gray(p))
    x = rng.standard_normal((2, 3, 7, 9)).astype(np.float32)
    for pad in (1, 3):
        got = images.replicate_pad(torch.from_numpy(x), pad)
        want = np.asarray(jimages.replicate_pad(jnp.asarray(x), pad))
        np.testing.assert_array_equal(got.numpy(), want)
    got = images.replicate_pad(torch.from_numpy(x[0, 0]), 2)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jimages.replicate_pad(jnp.asarray(x[0, 0]), 2)))
    batch = images.to_device_batch([x[0, 0], x[1, 0]], device="cpu")
    assert batch.shape == (2, 7, 9) and batch.device.type == "cpu"
    np.testing.assert_array_equal(
        batch.numpy(), np.asarray(jimages.to_device_batch([x[0, 0],
                                                            x[1, 0]])))


def test_render_uint8_pool_equals_one_process():
    """The process pool renders the same uint8 frames, in order, as one
    process (and as the frames the bench ships: clip(frame * 255))."""
    from visualslam_tpu_torch.io.synthetic import SyntheticSequence, render_uint8

    seq = SyntheticSequence(num_frames=9, h=48, w=64, n_dots=100,
                            trajectory="loop")
    ids = [8, 0, 3, 5, 1]
    one = render_uint8(seq, ids)
    assert one.dtype == np.uint8 and one.shape == (5, 48, 64)
    np.testing.assert_array_equal(render_uint8(seq, ids, workers=2), one)
    np.testing.assert_array_equal(
        one[0], np.clip(seq.frame(8) * 255.0, 0, 255).astype(np.uint8))

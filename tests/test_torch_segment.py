"""The port's fixed-order segment sum (ops/cuda/segment.py) against the JAX
package's `jax.ops.segment_sum`, on the CPU.

The plan (a stable argsort of the indices and each segment's range in it)
and the plain path (`index_add_`) give `jax.ops.segment_sum`'s bits, and so
does the kernel's arithmetic replayed in numpy from the plan: each
segment's rows added in ascending observation order, starting from 0. The
card's kernel runs that arithmetic (tests/test_torch_gpu.py holds it to the
CPU bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu_torch.ops.cuda.segment import (
    segment_plan,
    segment_sum,
    segment_sum_ref,
)


def _indices(r, kind: str, O: int, n: int) -> np.ndarray:
    if kind == "ties":            # many rows per segment, in random order
        return r.integers(0, n, O)
    if kind == "empty":           # only every third segment has rows
        return 3 * r.integers(0, n // 3, O)
    if kind == "past":            # n past the largest index
        return r.integers(0, n - 7, O)
    if kind == "grouped":         # ascending runs, as global BA's cameras
        return np.sort(r.integers(0, n, O))
    if kind == "grid":            # the window BA's [Kl, W] grid, camera axis
        return np.tile(np.arange(n), O // n)
    raise ValueError(kind)


# (kind, O, n, trailing shape, dtype, index dtype): widths 1 to 36, both
# float types, int32 and int64 indices
CASES = [
    ("ties", 600, 40, (6, 6), np.float32, np.int32),
    ("ties", 600, 40, (3,), np.float64, np.int64),
    ("ties", 2742, 67, (6,), np.float32, np.int64),
    ("empty", 300, 60, (3, 3), np.float32, np.int32),
    ("empty", 300, 60, (), np.float64, np.int32),
    ("past", 200, 50, (6, 3), np.float32, np.int64),
    ("past", 200, 50, (7, 7), np.float64, np.int32),
    ("grouped", 1500, 67, (6, 6), np.float64, np.int32),
    ("grid", 2040, 10, (6,), np.float32, np.int32),
    ("ties", 50, 1, (2,), np.float32, np.int64),
]


def _rows(r, shape, dtype) -> np.ndarray:
    """Values over six decades, so a sum's bits depend on its order."""
    return (r.standard_normal(shape)
            * 10.0 ** r.uniform(-3, 3, shape)).astype(dtype)


def _replay(x: np.ndarray, perm: np.ndarray, offsets: np.ndarray):
    """The kernel's arithmetic from the plan: per segment, 0 + its rows in
    perm order, one rounded add each."""
    n = len(offsets) - 1
    flat = x.reshape(len(x), -1)
    out = np.zeros((n, flat.shape[1]), x.dtype)
    for s in range(n):
        acc = np.zeros(flat.shape[1], x.dtype)
        for k in range(offsets[s], offsets[s + 1]):
            acc = acc + flat[perm[k]]
        out[s] = acc
    return out.reshape((n,) + x.shape[1:])


@pytest.mark.parametrize("kind,O,n,shape,dtype,idx_dtype", CASES)
def test_segment_sum_matches_jax_bit_for_bit(kind, O, n, shape, dtype,
                                             idx_dtype):
    r = np.random.default_rng(O + n + len(shape))
    idx = _indices(r, kind, O, n).astype(idx_dtype)
    x = _rows(r, (O,) + shape, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(x),
                                              jnp.asarray(idx), n))
    assert want.dtype == dtype

    plan = segment_plan(torch.from_numpy(idx), n)
    perm, offsets = plan.perm.numpy(), plan.offsets.numpy()
    # the plan: a stable argsort, and each segment's range in it
    np.testing.assert_array_equal(perm, np.argsort(idx, kind="stable"))
    np.testing.assert_array_equal(
        offsets, np.searchsorted(np.sort(idx), np.arange(n + 1)))
    assert plan.perm.dtype == plan.offsets.dtype == torch.int64
    assert plan.n == n

    got = segment_sum(torch.from_numpy(x), plan)
    assert got.dtype == torch.from_numpy(x).dtype and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(_replay(x, perm, offsets), want)
    if kind == "ties":
        # the order matters at these values: with each segment's rows
        # added in descending order, the bits part
        rev = np.concatenate([perm[offsets[s]:offsets[s + 1]][::-1]
                              for s in range(n)])
        assert not np.array_equal(_replay(x, rev, offsets), want)


@pytest.mark.parametrize("bad", [-1, 5])
def test_segment_sum_rejects_indices_outside_the_segments(bad):
    """index_add_'s contract: every index in [0, n); the CPU path raises on
    another (the kernel stops on a device-side assert)."""
    idx = torch.tensor([0, 2, bad, 4])
    plan = segment_plan(idx, 5)
    with pytest.raises(RuntimeError):
        segment_sum(torch.ones(4, 3), plan)


def test_segment_plan_takes_1d_indices_and_sums_on_its_device():
    with pytest.raises(ValueError):
        segment_plan(torch.zeros(2, 2, dtype=torch.int64), 2)
    plan = segment_plan(torch.tensor([1, 0, 1]), 3)
    got = segment_sum(torch.tensor([[1.0], [2.0], [4.0]]), plan)
    assert got.tolist() == [[2.0], [5.0], [0.0]]
    assert torch.equal(got, segment_sum_ref(
        torch.tensor([[1.0], [2.0], [4.0]]), plan))

"""The port's fixed-order segment sum (ops/cuda/segment.py) against the JAX
package's `jax.ops.segment_sum`, on the CPU.

The plan (a stable argsort of the indices, each segment's range in it and
length, and the list of long segments) and the plain path (`index_add_`)
give `jax.ops.segment_sum`'s bits, and so does the kernel's arithmetic
replayed in numpy from the plan: each segment's rows added in ascending
observation order, starting from 0, the long segments by a worker block
tile by tile and the rest by one thread per output. The card's kernel runs
that arithmetic (tests/test_torch_gpu.py holds it to the CPU bit for bit).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu_torch.ops.cuda.segment import (
    LONG_ROWS,
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


def _pose_graph_ends(r) -> np.ndarray:
    """The 256-node padded pose graph's source ends: 300 edges, the other
    724 of 1024 padding on node 0 (a long segment among short ones)."""
    i = np.zeros(1024, np.int64)
    i[:300] = r.integers(0, 256, 300)
    return i


# CASES' (kind, O, n, shape, dtype, index dtype) and three with long
# segments among short ones: the pose graph's padding, one segment alone,
# power-law lengths in shuffled rows
SCHEDULE_CASES = CASES + [
    ("pose_graph", 1024, 256, (6,), np.float32, np.int64),
    ("one_long", 3000, 1, (3,), np.float64, np.int32),
    ("power_law", 4000, 200, (6,), np.float32, np.int64),
]


def _schedule_indices(r, kind: str, O: int, n: int) -> np.ndarray:
    if kind == "pose_graph":
        return _pose_graph_ends(r)
    if kind == "one_long":
        return np.zeros(O, np.int64)
    if kind == "power_law":       # segment k drawn with weight (k + 1)^-1.2
        w = np.arange(1, n + 1) ** -1.2
        return r.choice(n, O, p=w / w.sum())
    return _indices(r, kind, O, n)


def _replay_schedule(x: np.ndarray, plan, tile_rows: int = 32):
    """The kernel's schedule from the plan, in numpy: worker block g sums
    long_ids[g] (for g < long_count) tile by tile, every column's chain
    over the tile's rows in order (the chain runs on across tiles, so any
    tile size gives the same bits); the remaining threads sum each output
    of a shorter segment, four rows a step. Each output must be written
    once."""
    perm, offsets = plan.perm.numpy(), plan.offsets.numpy()
    flat = x.reshape(len(x), -1)
    n, width = plan.n, flat.shape[1]
    out = np.zeros((n, width), x.dtype)
    writes = np.zeros((n, width), np.int64)
    count = int(plan.long_count[0])
    for g in range(plan.long_ids.shape[0]):
        if g >= count:
            continue
        s = int(plan.long_ids[g])
        acc = np.zeros(width, x.dtype)
        for t0 in range(offsets[s], offsets[s + 1], tile_rows):
            tile = flat[perm[t0:min(t0 + tile_rows, offsets[s + 1])]]
            for row in tile:
                acc = acc + row
        out[s] = acc
        writes[s] += 1
    for s in range(n):
        if offsets[s + 1] - offsets[s] >= LONG_ROWS:
            continue
        for c in range(width):
            acc = x.dtype.type(0)
            k = offsets[s]
            while k < offsets[s + 1]:
                for kk in range(k, min(k + 4, offsets[s + 1])):
                    acc = x.dtype.type(acc + flat[perm[kk], c])
                k += 4
            out[s, c] = acc
            writes[s, c] += 1
    np.testing.assert_array_equal(writes, 1)
    return out.reshape((n,) + x.shape[1:])


@pytest.mark.parametrize("kind,O,n,shape,dtype,idx_dtype", SCHEDULE_CASES)
def test_segment_plan_long_list_matches_numpy(kind, O, n, shape, dtype,
                                              idx_dtype):
    """Lengths, the long-segment list (ascending, then n) and its count."""
    r = np.random.default_rng(O + n)
    idx = _schedule_indices(r, kind, O, n).astype(idx_dtype)
    lengths = np.bincount(idx, minlength=n)
    plan = segment_plan(torch.from_numpy(idx), n)
    np.testing.assert_array_equal(plan.lengths.numpy(), lengths)
    assert plan.lengths.dtype == torch.int64
    long = np.flatnonzero(lengths >= LONG_ROWS)
    workers = min(n, O // LONG_ROWS)
    assert plan.long_ids.shape == (workers,)
    assert plan.long_ids.dtype == torch.int32
    np.testing.assert_array_equal(
        plan.long_ids.numpy(),
        np.concatenate([long, np.full(workers - len(long), n)]))
    assert plan.long_count.tolist() == [len(long)]
    if kind in ("pose_graph", "one_long", "grid", "power_law"):
        assert len(long) > 0
    if kind in ("pose_graph", "power_law"):
        assert (lengths < LONG_ROWS).sum() > 0


@pytest.mark.parametrize("kind,O,n,shape,dtype,idx_dtype", SCHEDULE_CASES)
def test_segment_schedule_replay_matches_jax(kind, O, n, shape, dtype,
                                             idx_dtype):
    """The kernel's schedule (long segments tile by tile, short ones per
    output) replayed from the plan gives jax.ops.segment_sum's bits."""
    r = np.random.default_rng(2 * O + n)
    idx = _schedule_indices(r, kind, O, n).astype(idx_dtype)
    x = _rows(r, (O,) + shape, dtype)
    with jax.enable_x64(dtype == np.float64):
        want = np.asarray(jax.ops.segment_sum(jnp.asarray(x),
                                              jnp.asarray(idx), n))
    got = _replay_schedule(x, segment_plan(torch.from_numpy(idx), n))
    np.testing.assert_array_equal(got, want)

"""The port's collectives over an in-process mesh against the JAX
package's under shard_map on conftest's 8-virtual-device CPU mesh: the
ring functions bit for bit (the same hop schedule, so the same float32
adds in the same order), the plain collectives within rounding, and the
virtual mesh's aliasing hazard (every hop a fresh tensor)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from visualslam_tpu.parallel import collectives as jcol
from visualslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from visualslam_tpu_torch.parallel import collectives as col
from visualslam_tpu_torch.parallel.mesh import Mesh, make_mesh, make_mesh_2d

CPU = torch.device("cpu")


def _jax_per_shard(fn, x, n):
    """fn(block) under shard_map over an n-device 'r' mesh; x [n, ...];
    returns the per-shard outputs stacked [n, ...] (numpy)."""
    mesh = jmake_mesh(n, axis="r")
    out = jax.jit(jax.shard_map(lambda v: fn(v[0])[None], mesh=mesh,
                                in_specs=P("r"), out_specs=P("r")))(
        jnp.asarray(x))
    return np.asarray(out)


def _shards(x):
    return [torch.from_numpy(np.array(v)) for v in x]


@pytest.mark.parametrize("n", [8, 3])
def test_ring_allreduce_equals_jax_bit_for_bit(rng, n):
    x = rng.standard_normal((n, 37)).astype(np.float32)  # 37 % n: padded
    want = _jax_per_shard(lambda v: jcol.ring_allreduce(v, "r"), x, n)
    got = col.ring_allreduce(_shards(x))
    for d in range(n):
        np.testing.assert_array_equal(got[d].numpy(), want[d])


@pytest.mark.parametrize("n", [8, 3])
def test_ring_reduce_scatter_and_all_gather_equal_jax_bit_for_bit(rng, n):
    x = rng.standard_normal((n, n, 5)).astype(np.float32)  # [dev, chunk, d]
    want_rs = _jax_per_shard(lambda v: jcol.ring_reduce_scatter(v, "r"),
                             x, n)
    want_ag = _jax_per_shard(
        lambda v: jcol.ring_all_gather(jcol.ring_reduce_scatter(v, "r"),
                                       "r"), x, n)
    rs = col.ring_reduce_scatter(_shards(x))
    ag = col.ring_all_gather(rs)
    for d in range(n):
        np.testing.assert_array_equal(rs[d].numpy(), want_rs[d])
        np.testing.assert_array_equal(ag[d].numpy(), want_ag[d])
    np.testing.assert_allclose(ag[0].numpy(), x.sum(0), atol=1e-5)


def test_ring_allreduce_matches_psum(rng):
    x = rng.standard_normal((8, 37)).astype(np.float32)
    ring = col.ring_allreduce(_shards(x))
    ps = col.psum(_shards(x))
    for d in range(8):
        np.testing.assert_allclose(ring[d].numpy(), ps[d].numpy(), atol=1e-4)
    np.testing.assert_allclose(ring[0].numpy(), x.sum(0), atol=1e-4)


def test_plain_collectives_match_jax(rng):
    """psum adds the shards in index order, XLA's all-reduce in its own:
    equal within 1e-6 relative; pmin, pmax and all_gather exactly."""
    x = rng.standard_normal((8, 4, 6)).astype(np.float32)
    ops = {
        "psum": (col.psum, lambda v: jax.lax.psum(v, "r")),
        "pmin": (col.pmin, lambda v: jax.lax.pmin(v, "r")),
        "pmax": (col.pmax, lambda v: jax.lax.pmax(v, "r")),
        "all_gather": (col.all_gather, lambda v: jax.lax.all_gather(v, "r")),
    }
    for name, (ours, theirs) in ops.items():
        want = _jax_per_shard(theirs, x, 8)
        got = ours(_shards(x))
        for d in range(8):
            if name == "psum":
                np.testing.assert_allclose(got[d].numpy(), want[d],
                                           rtol=1e-6, atol=1e-6)
            else:
                np.testing.assert_array_equal(got[d].numpy(), want[d])


def test_virtual_mesh_never_aliases(rng):
    """Four shards on one device: the inputs stay as they were, every
    output is its own tensor, and writing one shard's result leaves the
    others alone."""
    x = rng.standard_normal((4, 4, 3)).astype(np.float32)
    xs = _shards(x)
    for fn in (col.ring_reduce_scatter, col.ring_allreduce, col.psum,
               col.pmin, col.all_gather,
               lambda v: col.ring_all_gather([a[0] for a in v])):
        out = fn(xs)
        for d in range(4):
            np.testing.assert_array_equal(xs[d].numpy(), x[d])
        ptrs = {o.data_ptr() for o in out}
        assert len(ptrs) == 4, fn
        before = out[1].clone()
        out[0].add_(1.0)
        np.testing.assert_array_equal(out[1].numpy(), before.numpy())
        np.testing.assert_array_equal(xs[0].numpy(), x[0])


def test_make_mesh_shapes_and_cuda_requirement():
    m = make_mesh(8, devices=[CPU] * 8)
    assert isinstance(m, Mesh) and m.shape["shard"] == 8
    assert m.axis_names == ("shard",) and m.devices == (CPU,) * 8
    m2 = make_mesh_2d(2, 4, devices=[CPU] * 8)
    assert m2.shape == {"data": 2, "shard": 4} and m2.size == 8
    with pytest.raises(RuntimeError, match="only 3 devices"):
        make_mesh(4, devices=[CPU] * 3)
    if torch.cuda.device_count() < 2:
        # never a CPU fallback: a mesh of CUDA devices needs the devices
        with pytest.raises(RuntimeError, match="CUDA devices"):
            make_mesh(2)

"""The port's sharded 2-NN on a virtual 8-shard CPU mesh against the JAX
package's on conftest's 8-virtual-device mesh and against the full
[Ka, Kb] matrix: the same inputs, the tolerances of tests/test_dist_match.py,
indices equal off near-ties. The all-invalid shards make ties decide."""

import jax.numpy as jnp
import numpy as np
import torch

from test_dist_match import _full_2nn
from visualslam_tpu.parallel.dist_match import shard_descriptors as jshard
from visualslam_tpu.parallel.dist_match import sharded_2nn as j2nn
from visualslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from visualslam_tpu_torch.parallel.dist_match import (
    shard_descriptors,
    sharded_2nn,
)
from visualslam_tpu_torch.parallel.mesh import make_mesh

CPU8 = [torch.device("cpu")] * 8


def _both(qa, kb, vb):
    kb_s, vb_s = shard_descriptors(kb, vb, 8, device="cpu")
    got = sharded_2nn(torch.from_numpy(qa), kb_s, vb_s,
                      make_mesh(8, devices=CPU8))
    jkb, jvb = jshard(kb, vb, 8)
    want = j2nn(jnp.asarray(qa), jkb, jvb, jmake_mesh(8, axis="shard"))
    np.testing.assert_array_equal(kb_s.numpy(), np.asarray(jkb))
    np.testing.assert_array_equal(vb_s.numpy(), np.asarray(jvb))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_sharded_2nn_matches_jax_and_full(rng):
    Ka, Kb, D = 96, 1000, 64
    qa = rng.standard_normal((Ka, D)).astype(np.float32)
    kb = rng.standard_normal((Kb, D)).astype(np.float32)
    vb = rng.random(Kb) > 0.1
    (best, second, idx), (jb, js, ji) = _both(qa, kb, vb)
    assert idx.dtype == np.int32
    want_b, want_s, want_i = _full_2nn(qa, kb, vb)
    for got, ref in ((best, want_b), (second, want_s), (best, jb),
                     (second, js)):
        np.testing.assert_allclose(got, ref, rtol=2e-4, atol=1e-4)
    close = np.abs(want_s - want_b) < 1e-4
    assert ((idx == want_i) | close).mean() > 0.99
    assert ((idx == ji) | close).mean() > 0.99


def test_sharded_2nn_all_invalid_shard(rng):
    """Shards 0-1 hold no valid descriptor (every distance 1e30): they must
    not poison the result; ties go to the lowest index and shard."""
    Ka, Kb, D = 32, 64, 16
    qa = rng.standard_normal((Ka, D)).astype(np.float32)
    kb = rng.standard_normal((Kb, D)).astype(np.float32)
    vb = np.ones(Kb, bool)
    vb[:16] = False            # Kb_s = 8
    (best, second, idx), (jb, js, ji) = _both(qa, kb, vb)
    want_b, _, want_i = _full_2nn(qa, kb, vb)
    np.testing.assert_allclose(best, want_b, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(best, jb, rtol=2e-4, atol=1e-4)
    np.testing.assert_allclose(second, js, rtol=2e-4, atol=1e-4)
    assert (idx >= 16).all()
    np.testing.assert_array_equal(idx, ji)
    # every B row invalid: all distances tie at 1e30, the winner is
    # shard 0's row 0 in both packages
    (best, _, idx), (jb, _, ji) = _both(qa, kb, np.zeros(Kb, bool))
    assert (best == 1e30).all() and (idx == 0).all()
    np.testing.assert_array_equal(idx, ji)

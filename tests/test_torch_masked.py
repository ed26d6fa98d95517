"""utils/masked.{compact, merge, masked_mean} against the JAX package's
on the same numpy inputs, ties and all-invalid masks included: equal
(masked_mean's values are sums of dyadic fractions, exact in float32 in
any order)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from visualslam_tpu.utils import masked as jm
from visualslam_tpu_torch import utils
from visualslam_tpu_torch.utils import masked as tm


def _masks(rng, n):
    return {"random": rng.random(n) < 0.5, "all": np.ones(n, bool),
            "none": np.zeros(n, bool)}


@pytest.mark.parametrize("which", ["random", "all", "none"])
def test_compact_equals_jax(rng, which):
    n = 37
    mask = _masks(rng, n)[which]
    a = rng.standard_normal(n).astype(np.float32)
    b = rng.integers(0, 5, (n, 3)).astype(np.int32)
    got = tm.compact(torch.from_numpy(mask), torch.from_numpy(a),
                     torch.from_numpy(b))
    want = jm.compact(jnp.asarray(mask), jnp.asarray(a), jnp.asarray(b))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("which", ["random", "all", "none"])
def test_merge_equals_jax_with_ties(rng, which):
    na, nb, k = 20, 15, 12
    # integer-valued scores: many ties across and within the two sets
    sa = rng.integers(0, 4, na).astype(np.float32)
    sb = rng.integers(0, 4, nb).astype(np.float32)
    ma = _masks(rng, na)[which]
    mb = _masks(rng, nb)[which]
    xa = rng.standard_normal((na, 2)).astype(np.float32)
    xb = rng.standard_normal((nb, 2)).astype(np.float32)
    ia = np.arange(na, dtype=np.int32)
    ib = 100 + np.arange(nb, dtype=np.int32)
    got = tm.merge(*(torch.from_numpy(x) for x in (sa, ma, sb, mb)), k,
                   *(torch.from_numpy(x) for x in (xa, xb, ia, ib)))
    want = jm.merge(*(jnp.asarray(x) for x in (sa, ma, sb, mb)), k,
                    *(jnp.asarray(x) for x in (xa, xb, ia, ib)))
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("axis", [None, 0, 1])
@pytest.mark.parametrize("which", ["random", "all", "none"])
def test_masked_mean_equals_jax(rng, which, axis):
    x = (rng.integers(-64, 64, (6, 9)) / 8.0).astype(np.float32)
    mask = _masks(rng, 54)[which].reshape(6, 9)
    got = tm.masked_mean(torch.from_numpy(x), torch.from_numpy(mask), axis)
    want = jm.masked_mean(jnp.asarray(x), jnp.asarray(mask), axis)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_utils_exports_the_jax_packages_names():
    """utils/__init__ exports what the JAX package's does, masked helpers
    included."""
    for name in ("compact", "merge", "masked_mean", "top_k_select"):
        assert getattr(utils, name) is getattr(tm, name)

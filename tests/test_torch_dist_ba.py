"""The port's landmark-sharded BA on a virtual 8-shard CPU mesh against
the JAX package's run_ba_sharded on conftest's 8-virtual-device mesh and
against the port's one-device run_ba: the same problems
(tests/test_ba.make_ba_problem), the packing equal to the JAX package's,
the solves within tests/test_dist_ba.py's tolerances."""

import jax
import numpy as np
import pytest
import torch

from test_ba import make_ba_problem
from visualslam_tpu.backend.ba import BAProblem as JBAProblem
from visualslam_tpu.parallel import dist_ba as jdist
from visualslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from visualslam_tpu.utils.config import BAConfig as JBAConfig
from visualslam_tpu_torch.backend import ba as tba
from visualslam_tpu_torch.parallel.dist_ba import (
    run_ba_sharded,
    shard_problem,
    unshard_points,
)
from visualslam_tpu_torch.parallel.mesh import make_mesh
from visualslam_tpu_torch.utils.config import BAConfig
from visualslam_tpu_torch.utils.convert import from_numpy

CPU8 = [torch.device("cpu")] * 8


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread while this module runs: the suite runs files in
    parallel worker processes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _port(jp) -> tba.BAProblem:
    return from_numpy(tba.BAProblem, jax.tree_util.tree_map(np.asarray, jp),
                      device="cpu")


def _skewed_problem(rng):
    """tests/test_dist_ba.py's skewed problem: landmarks 0-7 observed 16
    times, the rest once."""
    n_cams, L = 4, 64
    cam_idx, lm_idx = [], []
    for k in range(L):
        for r in range(16 if k < 8 else 1):
            cam_idx.append(r % n_cams)
            lm_idx.append(k)
    O = len(lm_idx)
    return JBAProblem(
        R=np.tile(np.eye(3, dtype=np.float32), (n_cams, 1, 1)),
        t=np.zeros((n_cams, 3), np.float32),
        X=rng.normal(0, 1, (L, 3)).astype(np.float32),
        cam_idx=np.asarray(cam_idx, np.int32),
        lm_idx=np.asarray(lm_idx, np.int32),
        uv=np.zeros((O, 2), np.float32), obs_valid=np.ones(O, bool),
        cam_valid=np.ones(n_cams, bool), lm_valid=np.ones(L, bool))


@pytest.mark.parametrize("partition", ["balanced", "block"])
def test_shard_problem_packing_equals_jax(rng, partition):
    jp, *_ = make_ba_problem(rng, n_cams=4, n_lms=160)
    tp = _port(jp)
    sp = shard_problem(tp, 8, partition)
    jsp = jdist.shard_problem(jp, 8, partition)
    np.testing.assert_array_equal(sp.lm_order, jsp.lm_order)
    for name in ("X", "lm_valid", "cam_idx", "lm_idx", "uv", "obs_valid"):
        got, want = getattr(sp, name).numpy(), np.asarray(getattr(jsp, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert sp.X.shape == (8, 20, 3)
    X_rt = unshard_points(sp.X, sp.lm_order).numpy()
    np.testing.assert_array_equal(X_rt, tp.X.numpy())


def test_balanced_partition_shrinks_padding(rng):
    """As tests/test_dist_ba.py: the block partition puts the 8 heavy
    landmarks on shard 0 (O_s = 128), the balanced one spreads them
    (O_s = 16 + 7); the packing equals the JAX package's."""
    jp = _skewed_problem(rng)
    tp = _port(jp)
    sp_block = shard_problem(tp, 8, partition="block")
    sp_bal = shard_problem(tp, 8, partition="balanced")
    assert sp_block.obs_valid.shape[1] == 8 * 16
    assert sp_bal.obs_valid.shape[1] == 16 + 7
    assert int(sp_bal.obs_valid.sum()) == int(sp_block.obs_valid.sum()) \
        == len(jp.lm_idx)
    jsp = jdist.shard_problem(jax.tree_util.tree_map(np.asarray, jp), 8,
                              partition="balanced")
    np.testing.assert_array_equal(sp_bal.lm_order, jsp.lm_order)
    np.testing.assert_array_equal(sp_bal.obs_valid.numpy(),
                                  np.asarray(jsp.obs_valid))


@pytest.mark.parametrize("reduce", ["psum", "ring"])
def test_sharded_matches_jax_and_single(rng, reduce):
    jp, R_gt, *_ = make_ba_problem(rng, n_cams=5, n_lms=320)
    tp = _port(jp)
    cfg = BAConfig(iters=8)
    single = tba.run_ba(tp, cfg)
    sp = shard_problem(tp, 8)
    dist = run_ba_sharded(sp, cfg, make_mesh(8, devices=CPU8), reduce=reduce)
    ref = jdist.run_ba_sharded(jdist.shard_problem(jp, 8), JBAConfig(iters=8),
                               jmake_mesh(8, axis="shard"), reduce=reduce)
    assert float(dist.cost) < float(dist.initial_cost) * 1e-3
    X_d = unshard_points(dist.X, sp.lm_order).numpy()
    X_j = np.asarray(jdist.unshard_points(ref.X, sp.lm_order))
    for other, X_o in ((single, single.X.numpy()), (ref, X_j)):
        np.testing.assert_allclose(float(dist.initial_cost),
                                   float(other.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(dist.R.numpy(), np.asarray(other.R),
                                   atol=5e-4)
        np.testing.assert_allclose(dist.t.numpy(), np.asarray(other.t),
                                   atol=5e-3)
        np.testing.assert_allclose(X_d, X_o, atol=2e-2)
    for c in range(5):
        cos = (np.trace(dist.R[c].numpy().T @ R_gt[c]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.1


def test_balanced_matches_block_result(rng):
    jp, *_ = make_ba_problem(rng, n_cams=5, n_lms=320)
    tp = _port(jp)
    cfg = BAConfig(iters=6)
    mesh = make_mesh(8, devices=CPU8)
    r_block = run_ba_sharded(shard_problem(tp, 8, "block"), cfg, mesh)
    r_bal = run_ba_sharded(shard_problem(tp, 8, "balanced"), cfg, mesh)
    np.testing.assert_allclose(r_block.R.numpy(), r_bal.R.numpy(), atol=5e-4)
    np.testing.assert_allclose(float(r_block.cost), float(r_bal.cost),
                               rtol=1e-3, atol=1e-10)

"""The port's trajectory-sharded BA on a virtual CPU mesh against the JAX
package's run_ba_traj_sharded on conftest's virtual-device mesh and the
port's one-device run_ba: the packing equal to the JAX package's, the
dense step (ring Schur reduce-scatter + block-row CG) at Cs = 1 and 2,
and the matrix-free step, within tests/test_traj_ba.py's tolerances."""

import jax
import numpy as np
import pytest
import torch

from test_ba import make_ba_problem
from visualslam_tpu.parallel import traj_ba as jtraj
from visualslam_tpu.parallel.mesh import make_mesh as jmake_mesh
from visualslam_tpu.utils.config import BAConfig as JBAConfig
from visualslam_tpu_torch.backend import ba as tba
from visualslam_tpu_torch.parallel.mesh import make_mesh
from visualslam_tpu_torch.parallel.traj_ba import (
    pad_cameras,
    run_ba_traj_sharded,
    shard_problem_trajectory,
    unshard_traj,
)
from visualslam_tpu_torch.utils.config import BAConfig
from visualslam_tpu_torch.utils.convert import from_numpy


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


@pytest.mark.parametrize("n", [8, 4])
def test_traj_packing_equals_jax(rng, n):
    jp, *_ = make_ba_problem(rng, n_cams=8, n_lms=160)
    tp = _port(jp)
    sp = shard_problem_trajectory(tp, n)
    jsp = jtraj.shard_problem_trajectory(jp, n)
    np.testing.assert_array_equal(sp.lm_order, jsp.lm_order)
    for name in jtraj.TrajShardedBAProblem._fields[:-1]:
        got, want = getattr(sp, name).numpy(), np.asarray(getattr(jsp, name))
        assert got.dtype == want.dtype, name
        np.testing.assert_array_equal(got, want, err_msg=name)
    assert sp.R.shape == (n, 8 // n, 3, 3)
    R, t, X = unshard_traj(sp.R, sp.t, sp.X, sp.lm_order, 160)
    np.testing.assert_array_equal(R, tp.R.numpy())
    np.testing.assert_array_equal(t, tp.t.numpy())
    np.testing.assert_array_equal(X, tp.X.numpy())


@pytest.mark.parametrize("n", [3, 4])
def test_pad_cameras_to_a_multiple_of_the_shards(rng, n):
    """pad_cameras appends invalid identity cameras up to a multiple of n
    (10 -> 12) and leaves a problem already at a multiple as it is; the
    padded problem's initial cost is the unpadded one's."""
    jp, *_ = make_ba_problem(rng, n_cams=10, n_lms=160)
    tp = _port(jp)
    q = pad_cameras(tp, n)
    assert q.R.shape[0] == 12 and q.t.shape[0] == 12
    np.testing.assert_array_equal(q.R[:10].numpy(), tp.R.numpy())
    np.testing.assert_array_equal(q.t[:10].numpy(), tp.t.numpy())
    np.testing.assert_array_equal(q.R[10:].numpy(), np.tile(np.eye(
        3, dtype=np.float32), (2, 1, 1)))
    assert not q.t[10:].any() and not q.cam_valid[10:].any()
    np.testing.assert_array_equal(q.cam_valid[:10].numpy(),
                                  tp.cam_valid.numpy())
    assert q.R.dtype == tp.R.dtype and q.cam_valid.dtype == torch.bool
    assert pad_cameras(q, n) is q
    cfg = BAConfig(max_cameras=12, iters=1)
    assert float(tba.run_ba(q, cfg).initial_cost) == pytest.approx(
        float(tba.run_ba(tp, cfg.replace(max_cameras=10)).initial_cost),
        rel=1e-6)


def _solve_both(jp, n, cfg: dict, single_solver=None):
    tp = _port(jp)
    single = tba.run_ba(tp, BAConfig(**dict(
        cfg, solver=single_solver or cfg.get("solver", "schur_dense"))))
    sp = shard_problem_trajectory(tp, n)
    dist = run_ba_traj_sharded(sp, BAConfig(**cfg),
                               make_mesh(n, devices=[torch.device("cpu")] * n))
    jsp = jtraj.shard_problem_trajectory(jp, n)
    ref = jtraj.run_ba_traj_sharded(jsp, JBAConfig(**cfg),
                                    jmake_mesh(n, axis="shard"))
    L = tp.X.shape[0]
    got = unshard_traj(dist.R, dist.t, dist.X, sp.lm_order, L)
    want = unshard_traj(ref.R, ref.t, ref.X, jsp.lm_order, L)
    return dist, got, ref, want, single


@pytest.mark.parametrize("solver", ["schur_dense", "schur_mf"])
def test_traj_sharded_matches_jax_and_single(rng, solver):
    """Cs = 1 (8 cameras over 8 shards); schur_mf's one-device reference
    is the dense solve, as in tests/test_traj_ba.py."""
    jp, R_gt, *_ = make_ba_problem(rng, n_cams=8, n_lms=320)
    dist, (R, t, X), ref, want, single = _solve_both(
        jp, 8, dict(iters=8, cg_iters=64, max_cameras=8, solver=solver),
        single_solver="schur_dense")
    assert float(dist.cost) < float(dist.initial_cost) * 1e-3
    for other, (Ro, to, Xo) in ((ref, want), (single, (
            single.R.numpy(), single.t.numpy(), single.X.numpy()))):
        np.testing.assert_allclose(float(dist.initial_cost),
                                   float(other.initial_cost), rtol=1e-5)
        np.testing.assert_allclose(R, Ro, atol=5e-4)
        np.testing.assert_allclose(t, to, atol=5e-3)
        np.testing.assert_allclose(X, Xo, atol=2e-2)
    for c in range(8):
        cos = (np.trace(R[c].T @ R_gt[c]) - 1) / 2
        assert np.degrees(np.arccos(np.clip(cos, -1, 1))) < 0.1


def test_traj_sharded_multi_camera_blocks(rng):
    """Cs = 2 (8 cameras over 4 shards), dense step."""
    jp, *_ = make_ba_problem(rng, n_cams=8, n_lms=160)
    dist, (R, t, _), ref, (Rj, tj, _), single = _solve_both(
        jp, 4, dict(iters=6, cg_iters=64, max_cameras=8))
    for Ro, to in ((Rj, tj), (single.R.numpy(), single.t.numpy())):
        np.testing.assert_allclose(R, Ro, atol=1e-3)
        np.testing.assert_allclose(t, to, atol=1e-2)
    np.testing.assert_allclose(float(dist.cost), float(ref.cost), rtol=1e-2,
                               atol=1e-9)

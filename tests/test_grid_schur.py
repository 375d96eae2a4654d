"""Grid-order Schur path (ops/grid_schur.py) vs the general path.

Same math over dual-order storage — these tests pin the per-iteration
chi^2 trajectory and final state to the general schur solver on the
scale-workload generator, across refresh modes and preconditioners, and
check the chain-only gate.
"""

import dataclasses

import numpy as np
import pytest

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.ops import grid_schur
from toyslam_tpu.optimizer.gauss_newton import GaussNewton
from toyslam_tpu.sim import synthetic


@pytest.fixture(scope="module")
def graph():
    g, _, _ = synthetic.make_large_problem(
        num_poses=600, num_landmarks=600, obs_per_pose=6, seed=0,
        pose_bucket=64, landmark_bucket=64, edge_bucket=512,
    )
    return g


@pytest.mark.parametrize(
    "precond,refresh",
    [
        ("tridiag+coarse", 5),
        ("tridiag+coarse", 1),
        ("jacobi", 1),
        ("chunk+coarse", 5),
    ],
)
@pytest.mark.slow
def test_grid_matches_schur(graph, precond, refresh):
    base = OptimizerConfig(
        iterations=6, lr=1.0, solver="schur", exact_odom_jacobians=True,
        pcg_tol=1e-2, pcg_max_iters=15, pcg_restart_every=15,
        pcg_precond=precond, pcg_coarse_group=32,
        pcg_precond_refresh=refresh,
    )
    res_ref = GaussNewton(base).optimize(graph)
    cfg = dataclasses.replace(base, solver="schur_grid")
    res = GaussNewton(cfg).optimize(graph)
    e_ref = np.asarray(res_ref.errors)
    e = np.asarray(res.errors)
    valid = ~np.isnan(e_ref)
    # truncated-Newton trajectories (tol 1e-2, capped iterations)
    # compound f32 reduction-order differences across GN iterations
    np.testing.assert_allclose(e[valid], e_ref[valid], rtol=1e-2)
    np.testing.assert_allclose(
        np.asarray(res.graph.poses),
        np.asarray(res_ref.graph.poses),
        atol=1e-1,  # arena scale ~50 units; truncated-solve f32 divergence
    )


@pytest.mark.slow
def test_grid_laps_workload(graph):
    """Revisit workload (real loop closures in the OBSERVATIONS, chain
    odometry) — the grid path covers it."""
    g, gt, _ = synthetic.make_large_problem(
        num_poses=400, num_landmarks=200, obs_per_pose=5, seed=0, laps=2,
        pose_bucket=64, landmark_bucket=64, edge_bucket=512,
    )
    cfg = OptimizerConfig(
        iterations=8, lr=1.0, solver="schur_grid",
        exact_odom_jacobians=True, pcg_tol=1e-2, pcg_max_iters=30,
        pcg_restart_every=30, pcg_precond="tridiag+coarse",
        pcg_coarse_group=32, pcg_precond_refresh=4,
    )
    res = GaussNewton(cfg).optimize(g)
    e = np.asarray(res.errors)
    valid = e[~np.isnan(e)]
    assert valid[-1] < valid[0] * 0.01


def test_grid_rejects_closure_odometry(graph):
    odom = graph.odom
    i = np.asarray(odom.i).copy()
    j = np.asarray(odom.j).copy()
    mask = np.asarray(odom.mask).copy()
    slot = np.nonzero(mask == 0)[0][0]
    i[slot], j[slot], mask[slot] = 5, 99, 1.0
    g = dataclasses.replace(
        graph,
        odom=dataclasses.replace(odom, i=i, j=j, mask=mask),
    )
    with pytest.raises(ValueError, match="chain"):
        grid_schur.build_grid_plan(g)

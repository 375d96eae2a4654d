"""Partitioned SE(3)/BA (parallel/partition.py on FactorGraph3D) vs the
single-device schur3d solve — the distributed-BA composition."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.optimizer import GaussNewton
from toyslam_tpu.ops import schur3d
from toyslam_tpu.parallel import make_mesh, partitioned_linearize_solve
from toyslam_tpu.sim import synthetic3d


@pytest.fixture(scope="module")
def ba_setup():
    graph, poses_gt, _ = synthetic3d.make_ba_problem(
        num_poses=48, num_landmarks=160, obs_per_pose=16, seed=1,
    )
    return graph, poses_gt


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(axis="dev")


def _cfg(**kw):
    base = dict(
        solver="schur3d", pcg_tol=1e-10, pcg_max_iters=800,
        pcg_precond="jacobi", pcg_chunk=8, pcg_coarse_group=8,
        exact_odom_jacobians=True,
    )
    base.update(kw)
    return OptimizerConfig(**base)


@pytest.mark.parametrize("precond", ["jacobi", "chunk+coarse"])
def test_partitioned3d_solve_matches_single_device(ba_setup, mesh, precond):
    graph, _ = ba_setup
    n, m = graph.num_poses, graph.num_landmarks
    cfg = _cfg(pcg_precond=precond)
    lam = jnp.asarray(1e-3, jnp.float32)

    psolve = partitioned_linearize_solve(cfg, mesh)
    pg = psolve.prepare(graph)
    dxp_p, dxl_p, err_p, _ = jax.jit(psolve)(pg, lam)

    ssolve = schur3d.schur3d_linearize_solve(cfg)
    gn = GaussNewton(cfg)  # for _prepare's gather tables
    gs = gn._prepare(graph)
    dxp_s, dxl_s, err_s, _ = jax.jit(ssolve)(gs, lam)

    np.testing.assert_allclose(float(err_p), float(err_s), rtol=1e-5)
    ref = np.abs(np.asarray(dxp_s)).max()
    np.testing.assert_allclose(
        np.asarray(dxp_p)[:n], np.asarray(dxp_s)[:n],
        atol=5e-3 * max(ref, 1e-9), rtol=2e-2,
    )
    dxl_un = psolve.meta.unpermute_landmarks(np.asarray(dxl_p), m)
    refl = np.abs(np.asarray(dxl_s)).max()
    np.testing.assert_allclose(
        dxl_un, np.asarray(dxl_s)[:m],
        atol=5e-3 * max(refl, 1e-9), rtol=2e-2,
    )


def _to_f64(tree):
    return jax.tree_util.tree_map(
        lambda x: x.astype(jnp.float64)
        if hasattr(x, "dtype") and jnp.issubdtype(x.dtype, jnp.floating)
        else x,
        tree,
    )


def test_partitioned3d_solve_matches_single_device_f64(ba_setup, mesh):
    """f64 pin of ALGORITHMIC equivalence: the f32
    variant's rtol=2e-2 gate is justified as the f32 floor of the
    cond~3e6 BA Schur complement, but a ~1% partitioning bug would pass
    it.  In f64 the same two solves must agree to ~1e-9 — any structural
    error (wrong boundary column, missing observation, bad collective)
    shows up at O(1), so this pins f32 as a precision gap, not a
    correctness gap."""
    graph, _ = ba_setup
    with jax.enable_x64(True):
        g64 = _to_f64(graph)
        cfg = _cfg(pcg_precond="chunk+coarse", pcg_tol=1e-14,
                   pcg_max_iters=2000)
        lam = jnp.asarray(1e-3, jnp.float64)

        psolve = partitioned_linearize_solve(cfg, mesh)
        pg = psolve.prepare(g64)
        dxp_p, dxl_p, err_p, _ = jax.jit(psolve)(_to_f64(pg), lam)

        ssolve = schur3d.schur3d_linearize_solve(cfg)
        gs = GaussNewton(cfg)._prepare(g64)
        dxp_s, dxl_s, err_s, _ = jax.jit(ssolve)(_to_f64(gs), lam)

        n, m = graph.num_poses, graph.num_landmarks
        np.testing.assert_allclose(float(err_p), float(err_s), rtol=1e-12)
        ref = np.abs(np.asarray(dxp_s)).max()
        dev = np.abs(np.asarray(dxp_p)[:n] - np.asarray(dxp_s)[:n]).max()
        assert dev <= 1e-9 * max(ref, 1e-12), (dev, ref)
        dxl_un = psolve.meta.unpermute_landmarks(np.asarray(dxl_p), m)
        refl = np.abs(np.asarray(dxl_s)).max()
        devl = np.abs(dxl_un - np.asarray(dxl_s)[:m]).max()
        assert devl <= 1e-9 * max(refl, 1e-12), (devl, refl)


def test_partitioned3d_gauss_newton_recovers_trajectory(ba_setup, mesh):
    graph, poses_gt = ba_setup
    n = poses_gt.shape[0]
    cfg = _cfg(iterations=12, pcg_precond="chunk+coarse",
               reject_worse_steps=True, huber_delta=4.0)
    gn_p = GaussNewton(cfg, solve=partitioned_linearize_solve(cfg, mesh))
    r_p = gn_p.optimize(graph)
    est = np.asarray(r_p.graph.poses)[:n]
    ate0 = synthetic3d.pose_ate_rmse(np.asarray(graph.poses)[:n], poses_gt)
    ate = synthetic3d.pose_ate_rmse(est, poses_gt)
    assert ate < 0.3 * ate0, (ate, ate0)

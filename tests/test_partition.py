"""Keyframe/map-block state partitioning (parallel/partition.py) vs the
single-device Schur solve — the scalable distribution design.  Runs on the 8-fake-device CPU mesh."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
from toyslam_tpu.optimizer import GaussNewton
from toyslam_tpu.ops import schur
from toyslam_tpu.parallel import (
    build_partition,
    make_mesh,
    partitioned_linearize_solve,
)
from toyslam_tpu.sim import frontend, synthetic

import oracle


@pytest.fixture(scope="module")
def random_setup():
    rng = np.random.default_rng(9)
    prob = oracle.make_random_problem(
        rng, n_poses=25, n_lms=14, n_lm_edges=120
    )
    graph = oracle.problem_to_builder(prob).build()
    return prob, graph


@pytest.fixture(scope="module")
def mesh():
    return make_mesh(axis="dev")


def _cfg(**kw):
    base = dict(
        solver="schur", pcg_tol=1e-9, pcg_max_iters=800,
        pcg_precond="jacobi", pcg_chunk=8, pcg_coarse_group=8,
    )
    base.update(kw)
    return OptimizerConfig(**base)


@pytest.mark.parametrize(
    "precond", ["jacobi", "tridiag", "chunk", "chunk+coarse", "jacobi+coarse"]
)
def test_partitioned_solve_matches_single_device(random_setup, mesh, precond):
    _, graph = random_setup
    n, m = graph.num_poses, graph.num_landmarks
    cfg = _cfg(pcg_precond=precond)
    lam = jnp.asarray(1e-3)

    psolve = partitioned_linearize_solve(cfg, mesh)
    pg = psolve.prepare(graph)
    dxp_p, dxl_p, err_p, _ = jax.jit(psolve)(pg, lam)

    ssolve = schur.schur_linearize_solve(cfg)
    dxp_s, dxl_s, err_s, _ = jax.jit(ssolve)(graph, lam)

    np.testing.assert_allclose(float(err_p), float(err_s), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(dxp_p)[:n], np.asarray(dxp_s)[:n], rtol=2e-3, atol=1e-5
    )
    dxl_un = psolve.meta.unpermute_landmarks(np.asarray(dxl_p), m)
    np.testing.assert_allclose(
        dxl_un, np.asarray(dxl_s)[:m], rtol=2e-3, atol=1e-5
    )


def test_partitioned_exact_odom_jacobians(random_setup, mesh):
    _, graph = random_setup
    n = graph.num_poses
    cfg = _cfg(exact_odom_jacobians=True)
    lam = jnp.asarray(1e-3)
    psolve = partitioned_linearize_solve(cfg, mesh)
    pg = psolve.prepare(graph)
    dxp_p, _, err_p, _ = jax.jit(psolve)(pg, lam)
    ssolve = schur.schur_linearize_solve(cfg)
    dxp_s, _, err_s, _ = jax.jit(ssolve)(graph, lam)
    np.testing.assert_allclose(float(err_p), float(err_s), rtol=1e-5)
    np.testing.assert_allclose(
        np.asarray(dxp_p)[:n], np.asarray(dxp_s)[:n], rtol=2e-3, atol=1e-5
    )


def test_partitioned_gauss_newton_end_to_end(random_setup, mesh):
    _, graph = random_setup
    n = graph.num_poses
    cfg = _cfg(iterations=8, pcg_precond="chunk+coarse")
    gn_p = GaussNewton(cfg, solve=partitioned_linearize_solve(cfg, mesh))
    gn_s = GaussNewton(cfg)
    r_p = gn_p.optimize(graph)
    r_s = gn_s.optimize(graph)
    np.testing.assert_allclose(
        np.asarray(r_p.graph.poses)[:n],
        np.asarray(r_s.graph.poses)[:n],
        atol=5e-3,
    )


@pytest.mark.slow
def test_multi_loop_partitioned_recovers_trajectory(mesh):
    """The realistic workload: 300-pose multi-loop circuit with dense
    revisits (loop closures).  The partitioned optimizer must reach the
    same ATE regime as the single-device solver, and the contiguous
    keyframe cut must stay cheap (small boundary)."""
    cfg = SlamConfig(
        sim=SimConfig(robot_steps=300, seed=0),
        optimizer=OptimizerConfig(
            iterations=15, solver="schur", pcg_tol=1e-8,
            pcg_max_iters=500, pcg_precond="chunk+coarse",
            pcg_chunk=8, pcg_coarse_group=8,
        ),
    )
    controls = synthetic.multi_loop_controls(299, loop_steps=150)
    sim = frontend.simulate(cfg.sim, controls=controls)
    graph, _ = frontend.build_graph(sim, cfg)

    psolve = partitioned_linearize_solve(cfg.optimizer, mesh)
    gn_p = GaussNewton(cfg.optimizer, solve=psolve)
    r_p = gn_p.optimize(graph)
    est_p = np.asarray(r_p.graph.poses)[:300]

    gn_s = GaussNewton(cfg.optimizer)
    r_s = gn_s.optimize(graph)
    est_s = np.asarray(r_s.graph.poses)[:300]

    ate_dr = frontend.ate_rmse(sim.poses_dr, sim.poses_gt)
    ate_p = frontend.ate_rmse(est_p, sim.poses_gt)
    ate_s = frontend.ate_rmse(est_s, sim.poses_gt)
    assert ate_p < 0.5 * ate_dr
    assert abs(ate_p - ate_s) < 0.05 * max(ate_s, 1e-6) + 1e-3

    # locality: a contiguous keyframe cut crosses few odometry edges.
    # (boundary_lm_frac is 1.0 here BY CONSTRUCTION: the circuit revisits
    # every landmark each lap from poses on different devices — landmark
    # locality is asserted on the serpentine workload instead.)
    meta = psolve.meta
    assert meta.boundary_pose_frac < 0.1


def test_per_device_memory_scales_down():
    """The point of state partitioning: per-device bytes ~ 1/D (+ small
    boundary terms), unlike the edge-sharded path whose states replicate.
    """
    graph, _, _ = synthetic.make_large_problem(
        num_poses=600, num_landmarks=400, obs_per_pose=5, seed=2,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )

    def per_device_bytes(n_dev):
        pg, meta = build_partition(graph, n_dev, align=8, coarse_group=8)
        total = sum(
            np.asarray(x).nbytes for x in jax.tree.leaves(pg)
        )
        return total / n_dev, meta  # every array is sharded along axis 0

    b1, _ = per_device_bytes(1)
    b4, meta4 = per_device_bytes(4)
    b8, meta8 = per_device_bytes(8)
    # edge padding + boundary tables cost something, but per-device memory
    # must still drop by >= 4x from D=1 to D=8 (measured: 7.1x)
    assert b8 < b1 / 4.0, (b1, b8)
    # landmark locality on the serpentine sweep: observations are local,
    # so a minority of landmarks is seen from more than one keyframe block
    # (at D=8 this tiny 600-pose problem leaves only ~2 sweep rows per
    # block, so row-adjacent observations cross cuts — locality is a
    # function of block size, asserted where blocks span several rows)
    assert meta4.boundary_lm_frac < 0.5, meta4.boundary_lm_frac


def test_landmark_permutation_roundtrip():
    graph, _, _ = synthetic.make_large_problem(
        num_poses=200, num_landmarks=150, obs_per_pose=4, seed=3,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )
    m = graph.num_landmarks
    pg, meta = build_partition(graph, 4, align=8, coarse_group=8)
    # permuted landmarks map back exactly onto the originals
    back = meta.unpermute_landmarks(np.asarray(pg.landmarks), m)
    orig = np.asarray(graph.landmarks)
    mask = np.asarray(graph.lm_mask) > 0
    np.testing.assert_array_equal(back[mask], orig[mask])
    # every real landmark got exactly one slot
    real_new = meta.new_of_old_lm[mask]
    assert (real_new >= 0).all()
    assert len(np.unique(real_new)) == mask.sum()

"""Schur + PCG path must reproduce the dense direct solve."""

import numpy as np
import jax.numpy as jnp
import pytest

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.models.graph import FactorGraph2D
from toyslam_tpu.optimizer import GaussNewton
from toyslam_tpu.ops import assemble, schur

import oracle


@pytest.fixture(scope="module")
def setup():
    rng = np.random.default_rng(5)
    prob = oracle.make_random_problem(rng, n_poses=15, n_lms=10, n_lm_edges=60)
    builder = oracle.problem_to_builder(prob)
    graph = builder.build()
    return prob, builder, graph


def _dense_hb(graph: FactorGraph2D):
    sys = assemble.assemble_dense(graph, huber_delta=1.5)
    return np.asarray(sys.H, np.float64), np.asarray(sys.b, np.float64)


def _blocks_to_dense(sys: schur.BlockSystem, graph: FactorGraph2D):
    n, m = graph.num_poses, graph.num_landmarks
    D = 3 * n + 2 * m
    H = np.zeros((D, D))
    for p in range(n):
        H[3 * p : 3 * p + 3, 3 * p : 3 * p + 3] = np.asarray(sys.hpp_diag[p])
    oi = np.asarray(graph.odom.i)
    oj = np.asarray(graph.odom.j)
    off = np.asarray(sys.hpp_off)
    mask1 = np.asarray(graph.odom.mask)
    for e in range(len(oi)):
        if not mask1[e]:
            continue
        i, j = oi[e], oj[e]
        H[3 * i : 3 * i + 3, 3 * j : 3 * j + 3] += off[e]
        H[3 * j : 3 * j + 3, 3 * i : 3 * i + 3] += off[e].T
    for k in range(m):
        o = 3 * n + 2 * k
        H[o : o + 2, o : o + 2] = np.asarray(sys.hll[k])
    lp = np.asarray(graph.lm_edges.pose)
    ll = np.asarray(graph.lm_edges.lm)
    hpl = np.asarray(sys.hpl)
    mask2 = np.asarray(graph.lm_edges.mask)
    for e in range(len(lp)):
        if not mask2[e]:
            continue
        p, k = lp[e], ll[e]
        o1, o2 = 3 * p, 3 * n + 2 * k
        H[o1 : o1 + 3, o2 : o2 + 2] += hpl[e]
        H[o2 : o2 + 2, o1 : o1 + 3] += hpl[e].T
    b = np.concatenate(
        [np.asarray(sys.bp).ravel(), np.asarray(sys.bl).ravel()]
    )
    return H, b


def test_block_assembly_matches_dense(setup):
    _, _, graph = setup
    sys = schur.assemble_blocks(graph, huber_delta=1.5)
    H_blk, b_blk = _blocks_to_dense(sys, graph)
    H_dense, b_dense = _dense_hb(graph)
    np.testing.assert_allclose(H_blk, H_dense, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(b_blk, b_dense, rtol=2e-3, atol=2e-3)


def test_schur_matvec_matches_dense(setup):
    _, builder, graph = setup
    n, m = graph.num_poses, graph.num_landmarks
    lam = jnp.asarray(1e-3)
    sys = schur.damp(schur.assemble_blocks(graph, huber_delta=1.5), lam)
    hll_inv = schur.inv2x2(sys.hll)
    H, _ = _blocks_to_dense(sys, graph)
    Hpp = H[: 3 * n, : 3 * n]
    Hpl = H[: 3 * n, 3 * n :]
    Hll = H[3 * n :, 3 * n :]
    S = Hpp - Hpl @ np.linalg.inv(Hll) @ Hpl.T

    rng = np.random.default_rng(0)
    x = rng.normal(size=(n, 3)).astype(np.float32)
    got = np.asarray(
        schur.schur_matvec(sys, hll_inv, graph, jnp.asarray(x))
    ).ravel()
    want = S @ x.ravel()
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-2)


def test_schur_solve_matches_dense_solve(setup):
    _, builder, graph = setup
    n, m = graph.num_poses, graph.num_landmarks
    lam = jnp.asarray(1e-3)
    sys = schur.assemble_blocks(graph, huber_delta=1.5)
    dx_p, dx_l, _ = schur.schur_solve(sys, graph, lam, tol=1e-8, max_iters=500)

    H, b = _dense_hb(graph)
    D = H.shape[0]
    dx_dense = np.linalg.solve(H + float(lam) * np.eye(D), -b)
    np.testing.assert_allclose(
        np.asarray(dx_p).ravel(), dx_dense[: 3 * n], rtol=1e-2, atol=1e-3
    )
    np.testing.assert_allclose(
        np.asarray(dx_l).ravel(), dx_dense[3 * n :], rtol=1e-2, atol=1e-3
    )


def test_gauss_newton_with_schur_solver(setup):
    prob, builder, graph = setup
    n = builder.num_poses
    r_dense = GaussNewton(OptimizerConfig(iterations=10)).optimize(graph)
    r_schur = GaussNewton(
        OptimizerConfig(iterations=10, solver="schur", pcg_tol=1e-8,
                        pcg_max_iters=500)
    ).optimize(graph)
    np.testing.assert_allclose(
        np.asarray(r_schur.graph.poses[:n]),
        np.asarray(r_dense.graph.poses[:n]),
        atol=5e-3,
    )
    errs_d = np.asarray(r_dense.errors)
    errs_s = np.asarray(r_schur.errors)
    valid = ~np.isnan(errs_d) & ~np.isnan(errs_s)
    np.testing.assert_allclose(errs_s[valid], errs_d[valid], rtol=1e-2)


def _random_block_tridiag(rng, n, d):
    """Random SPD block-tridiagonal (diag, upper) + its dense form."""
    diag = np.zeros((n, d, d))
    upper = np.zeros((n, d, d))
    for v in range(n):
        a = rng.normal(size=(d, d))
        diag[v] = a @ a.T + (2.0 * d) * np.eye(d)  # diagonally dominant
    for v in range(n - 1):
        upper[v] = 0.5 * rng.normal(size=(d, d))
    D = n * d
    M = np.zeros((D, D))
    for v in range(n):
        M[v * d : v * d + d, v * d : v * d + d] = diag[v]
        if v < n - 1:
            M[v * d : v * d + d, (v + 1) * d : (v + 2) * d] = upper[v]
            M[(v + 1) * d : (v + 2) * d, v * d : v * d + d] = upper[v].T
    return diag, upper, M


@pytest.mark.parametrize("n,d", [(1, 3), (2, 3), (7, 3), (32, 3), (33, 2),
                                 (50, 6)])
def test_tridiag_pcr_solves_exactly(n, d):
    """PCR factorization must solve M z = r to f32 accuracy (it is an exact
    method, not an approximation)."""
    rng = np.random.default_rng(3)
    diag, upper, M = _random_block_tridiag(rng, n, d)
    r = rng.normal(size=(n, d))
    pre = schur.build_tridiag_precond(
        jnp.asarray(diag, jnp.float32), jnp.asarray(upper, jnp.float32)
    )
    z = np.asarray(schur.tridiag_apply(pre, jnp.asarray(r, jnp.float32)))
    want = np.linalg.solve(M, r.ravel()).reshape(n, d)
    np.testing.assert_allclose(z, want, rtol=2e-4, atol=2e-4)


@pytest.mark.slow
def test_tridiag_precond_cuts_pcg_iterations():
    """On a chain-dominated graph the tridiag preconditioner must converge
    in far fewer PCG iterations than block-Jacobi."""
    from toyslam_tpu.ops import blockmath as bm
    from toyslam_tpu.ops.gather_plan import attach_plan
    from toyslam_tpu.sim import synthetic

    graph, _, _ = synthetic.make_large_problem(
        num_poses=400, num_landmarks=300, obs_per_pose=4, seed=0,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )
    graph = attach_plan(graph)
    lam = jnp.asarray(1e-3, jnp.float32)
    sys = schur.assemble_blocks(graph, 1.5, exact_odom_jacobians=True)
    d = schur.damp(sys, lam)
    hll_inv = schur.inv_blocks(d.hll)
    rhs = -d.bp + schur.hpl_matvec(
        d, graph.lm_edges.pose, graph.lm_edges.lm,
        bm.mv(hll_inv, d.bl), graph.num_poses, None, graph.plan,
    )
    op = schur.make_plan_operator(d, hll_inv, graph)
    s_diag = schur.plan_s_diag(op)
    matvec = lambda x: schur.plan_matvec(op, x)  # noqa: E731

    m_inv = jnp.linalg.inv(s_diag)
    res_j = schur.pcg(matvec, lambda r: bm.mv(m_inv, r), rhs, 1e-3, 1000)

    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, graph.num_poses)
    pre = schur.build_tridiag_precond(s_diag, upper)
    chol_c = schur.build_coarse_precond(d, hll_inv, graph, 16)
    res_t = schur.pcg(
        matvec,
        lambda r: schur.tridiag_apply(pre, r) + schur.coarse_apply(
            chol_c, 16, r),
        rhs, 1e-3, 1000,
    )

    it_j, it_t = int(res_j.iterations), int(res_t.iterations)
    # measured on this problem: jacobi 120 iters, two-level 33
    assert it_t * 2 < it_j, (it_t, it_j)
    # both actually converged to the requested tolerance
    rhs_norm = float(jnp.linalg.norm(rhs))
    assert float(res_j.residual_norm) <= 1.5e-3 * rhs_norm
    assert float(res_t.residual_norm) <= 1.5e-3 * rhs_norm


def test_two_level_preconditioner_is_spd_and_consistent():
    """The additive two-level preconditioner must be symmetric positive
    definite (PCG requirement): check z^T M^-1 z > 0 and symmetry
    <M^-1 a, b> == <a, M^-1 b> on random vectors."""
    from toyslam_tpu.ops import blockmath as bm
    from toyslam_tpu.ops.gather_plan import attach_plan
    from toyslam_tpu.sim import synthetic

    graph, _, _ = synthetic.make_large_problem(
        num_poses=200, num_landmarks=150, obs_per_pose=4, seed=1,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )
    graph = attach_plan(graph)
    sys = schur.assemble_blocks(graph, 1.5, exact_odom_jacobians=True)
    d = schur.damp(sys, jnp.asarray(1e-3, jnp.float32))
    hll_inv = schur.inv_blocks(d.hll)
    op = schur.make_plan_operator(d, hll_inv, graph)
    s_diag = schur.plan_s_diag(op)
    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, graph.num_poses)
    pre = schur.build_tridiag_precond(s_diag, upper)
    chol_c = schur.build_coarse_precond(d, hll_inv, graph, 16)

    def m_inv(r):
        return schur.tridiag_apply(pre, r) + schur.coarse_apply(chol_c, 16, r)

    rng = np.random.default_rng(0)
    a = jnp.asarray(rng.normal(size=(graph.num_poses, 3)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(graph.num_poses, 3)), jnp.float32)
    za, zb = m_inv(a), m_inv(b)
    assert float(jnp.vdot(a, za)) > 0.0
    assert float(jnp.vdot(b, zb)) > 0.0
    lhs, rhs_ = float(jnp.vdot(za, b)), float(jnp.vdot(a, zb))
    assert abs(lhs - rhs_) <= 1e-3 * max(abs(lhs), abs(rhs_)), (lhs, rhs_)


def test_coarse_precond_ragged_group():
    """``coarse_group`` need not divide the pose count: the last coarse
    aggregate is smaller (ceil-grouping).  Regression for the 100k-scale
    feasibility run, where group came from a target coarse size and the
    padded pose count was not a multiple (AssertionError pre-fix).  The
    ragged two-level preconditioner must still be SPD-consistent and must
    still let PCG converge."""
    from toyslam_tpu.ops import blockmath as bm
    from toyslam_tpu.ops.gather_plan import attach_plan
    from toyslam_tpu.sim import synthetic

    graph, _, _ = synthetic.make_large_problem(
        num_poses=200, num_landmarks=150, obs_per_pose=4, seed=1,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )
    graph = attach_plan(graph)
    assert graph.num_poses % 48 != 0  # the point of the test
    sys = schur.assemble_blocks(graph, 1.5, exact_odom_jacobians=True)
    d = schur.damp(sys, jnp.asarray(1e-3, jnp.float32))
    hll_inv = schur.inv_blocks(d.hll)
    op = schur.make_plan_operator(d, hll_inv, graph)
    s_diag = schur.plan_s_diag(op)
    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, graph.num_poses)
    pre = schur.build_tridiag_precond(s_diag, upper)
    chol_c = schur.build_coarse_precond(d, hll_inv, graph, 48)
    assert not bool(jnp.any(jnp.isnan(chol_c)))

    def m_inv(r):
        return schur.tridiag_apply(pre, r) + schur.coarse_apply(chol_c, 48, r)

    rng = np.random.default_rng(2)
    a = jnp.asarray(rng.normal(size=(graph.num_poses, 3)), jnp.float32)
    b = jnp.asarray(rng.normal(size=(graph.num_poses, 3)), jnp.float32)
    za, zb = m_inv(a), m_inv(b)
    assert float(jnp.vdot(a, za)) > 0.0
    lhs, rhs_ = float(jnp.vdot(za, b)), float(jnp.vdot(a, zb))
    assert abs(lhs - rhs_) <= 1e-3 * max(abs(lhs), abs(rhs_)), (lhs, rhs_)

    rhs = -d.bp + schur.hpl_matvec(
        d, graph.lm_edges.pose, graph.lm_edges.lm,
        bm.mv(hll_inv, d.bl), graph.num_poses, None, graph.plan,
    )
    res = schur.pcg(lambda x: schur.plan_matvec(op, x), m_inv, rhs,
                    1e-3, 1000)
    rhs_norm = float(jnp.linalg.norm(rhs))
    assert float(res.residual_norm) <= 1.5e-3 * rhs_norm


def test_chunk_precond_matches_tridiag_when_unchunked():
    """With chunk >= N (no boundary cuts) the chunked preconditioner solves
    the SAME block-tridiagonal system as the PCR factorization — the two
    applies must agree to f32 roundoff.  This is the correctness oracle
    for build_chunk_precond's scatter/equilibrate/invert pipeline."""
    from toyslam_tpu.ops.gather_plan import attach_plan
    from toyslam_tpu.sim import synthetic

    graph, _, _ = synthetic.make_large_problem(
        num_poses=200, num_landmarks=150, obs_per_pose=4, seed=1,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )
    graph = attach_plan(graph)
    sys = schur.assemble_blocks(graph, 1.5, exact_odom_jacobians=True)
    d = schur.damp(sys, jnp.asarray(1e-3, jnp.float32))
    hll_inv = schur.inv_blocks(d.hll)
    op = schur.make_plan_operator(d, hll_inv, graph)
    s_diag = schur.plan_s_diag(op)
    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, graph.num_poses)

    pre_t = schur.build_tridiag_precond(s_diag, upper)
    inv_full = schur.build_chunk_precond(s_diag, upper, graph.num_poses)

    rng = np.random.default_rng(0)
    r = jnp.asarray(rng.normal(size=(graph.num_poses, 3)), jnp.float32)
    z_t = schur.tridiag_apply(pre_t, r)
    z_c = schur.chunk_apply(inv_full, r)
    rel = float(jnp.linalg.norm(z_t - z_c) / jnp.linalg.norm(z_t))
    assert rel < 1e-5, rel


@pytest.mark.slow
def test_chunk_coarse_pcg_converges_like_tridiag_coarse():
    """chunk+coarse must not cost materially more PCG iterations than
    tridiag+coarse (the boundary cuts drop 1/chunk of the chain couplings;
    the coarse level owns the global modes).  Measured on this problem:
    both 33 iterations.  Also end-to-end: a full GaussNewton optimize with
    pcg_precond="chunk+coarse" reaches the same chi2."""
    from toyslam_tpu.config import OptimizerConfig
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.ops import blockmath as bm
    from toyslam_tpu.ops.gather_plan import attach_plan
    from toyslam_tpu.sim import synthetic

    graph, _, _ = synthetic.make_large_problem(
        num_poses=400, num_landmarks=300, obs_per_pose=4, seed=0,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )
    graph = attach_plan(graph)
    sys = schur.assemble_blocks(graph, 1.5, exact_odom_jacobians=True)
    d = schur.damp(sys, jnp.asarray(1e-3, jnp.float32))
    hll_inv = schur.inv_blocks(d.hll)
    op = schur.make_plan_operator(d, hll_inv, graph)
    s_diag = schur.plan_s_diag(op)
    upper = schur.chain_upper(d, graph.odom.i, graph.odom.j, graph.num_poses)
    rhs = -d.bp + schur.hpl_matvec(
        d, graph.lm_edges.pose, graph.lm_edges.lm,
        bm.mv(hll_inv, d.bl), graph.num_poses, None, graph.plan,
    )
    matvec = lambda x: schur.plan_matvec(op, x)  # noqa: E731
    chol_c = schur.build_coarse_precond(d, hll_inv, graph, 16)
    pre_t = schur.build_tridiag_precond(s_diag, upper)
    inv_k = schur.build_chunk_precond(s_diag, upper, 64)
    res_t = schur.pcg(
        matvec,
        lambda r: schur.tridiag_apply(pre_t, r)
        + schur.coarse_apply(chol_c, 16, r),
        rhs, 1e-3, 1000,
    )
    res_c = schur.pcg(
        matvec,
        lambda r: schur.chunk_apply(inv_k, r)
        + schur.coarse_apply(chol_c, 16, r),
        rhs, 1e-3, 1000,
    )
    it_t, it_c = int(res_t.iterations), int(res_c.iterations)
    assert it_c <= it_t * 1.5 + 5, (it_c, it_t)
    rhs_norm = float(jnp.linalg.norm(rhs))
    assert float(res_c.residual_norm) <= 1.5e-3 * rhs_norm

    # end-to-end GN equivalence at the optimum
    def run(pc):
        cfg = OptimizerConfig(
            iterations=10, lr=1.0, solver="schur",
            exact_odom_jacobians=True, pcg_max_iters=300,
            pcg_precond=pc, pcg_coarse_group=16, pcg_chunk=64,
        )
        gn = GaussNewton(cfg)
        r = gn.optimize(gn._prepare(graph))
        errs = np.asarray(r.errors)
        return float(errs[~np.isnan(errs)][-1])

    chi_t, chi_c = run("tridiag+coarse"), run("chunk+coarse")
    assert abs(chi_t - chi_c) <= 0.02 * max(chi_t, 1.0), (chi_t, chi_c)


def _spd_inverse_residual(a32, x):
    """Equilibrated residual ||I - A X||_max against the f32-rounded
    input (the f32 cast alone perturbs the true inverse by ~cond*eps, so
    measuring against a f64 original would conflate input rounding with
    solver convergence)."""
    s = 1.0 / np.sqrt(np.diag(a32).astype(np.float64))
    ae = a32.astype(np.float64) * s[:, None] * s[None, :]
    xe = x.astype(np.float64) / (s[:, None] * s[None, :])
    return np.abs(ae @ xe - np.eye(a32.shape[0])).max()


def test_spd_inverse_converges_within_cond_bound():
    """spd_inverse derives its iteration count from the caller's
    condition bound (a fixed 24 silently under-converged at
    high cond).  In the operating envelope — call sites boost the
    diagonal 1e-4 so equilibrated cond is ~1e4 — the derived count must
    reach the f32 floor, an under-budgeted count must not (documents
    that the count matters), and scaling cond_bound up must extend the
    budget accordingly."""
    rng = np.random.default_rng(3)
    q, _ = np.linalg.qr(rng.standard_normal((96, 96)))
    a32 = ((q * np.geomspace(1.0, 1e4, 96)) @ q.T).astype(np.float32)
    x = np.asarray(schur.spd_inverse(jnp.asarray(a32)))
    assert _spd_inverse_residual(a32, x) < 5e-2
    np.testing.assert_allclose(x, x.T, rtol=0, atol=0)
    # under-budgeted: the slow phase alone needs ~log2(cond) steps —
    # the derived count is load-bearing, not decorative
    x8 = np.asarray(schur.spd_inverse(jnp.asarray(a32), ns_iters=8))
    assert _spd_inverse_residual(a32, x8) > 0.1


def test_chol_small_clamped_pivot_stays_bounded():
    """A block whose early pivot rounds to ~0 must yield a FINITE bounded
    factor: the old absolute 1e-30 clamp produced l=1e-15 pivots whose
    divided columns blew up to ~1e30/inf)."""
    # a00 ~ 0 with O(1) off-diagonals: the first pivot clamps
    a3 = np.array([
        [[0.0, 0.7, 0.3],
         [0.7, 2.0, 0.1],
         [0.3, 0.1, 1.5]],
        # and a healthy SPD block must factor exactly
        [[4.0, 1.0, 0.5],
         [1.0, 3.0, 0.2],
         [0.5, 0.2, 2.0]],
    ], np.float32)
    l = np.asarray(schur._chol_small(jnp.asarray(a3)))
    assert np.isfinite(l).all()
    scale = np.abs(a3).max()
    assert np.abs(l).max() < 10 * np.sqrt(scale), np.abs(l).max()
    np.testing.assert_allclose(
        l[1] @ l[1].T, a3[1], rtol=1e-5, atol=1e-5
    )
    # 2x2 variant: same hazard through _chol2x2
    a2 = np.array([[[0.0, 0.9], [0.9, 1.0]]], np.float32)
    l2 = np.asarray(schur._chol_small(jnp.asarray(a2)))
    assert np.isfinite(l2).all() and np.abs(l2).max() < 10.0

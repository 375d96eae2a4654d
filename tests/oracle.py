"""Independent numpy oracle for the reference optimizer's math.

Re-derives (does not copy) the per-edge residual/Jacobian formulas and the
dense H/b assembly semantics of the reference Python optimizer
(python/optimizer/graph_optimizer.py:94-150, edges2d.py:21-78) so the JAX
implementation can be checked block-for-block.  Written against the spec in
SURVEY.md §2/§7, state layout [poses*3 | landmarks*2].
"""

from __future__ import annotations

import numpy as np


def rot(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s], [s, c]])


def wrap(theta):
    return np.arctan2(np.sin(theta), np.cos(theta))


def odom_residual(pi, pj, meas):
    """delta = meas^-1 * (pi^-1 * pj) as (x, y, theta)."""
    Ri, Rj, Rm = rot(pi[2]), rot(pj[2]), rot(meas[2])
    rel_t = Ri.T @ (pj[:2] - pi[:2])
    rel_th = pj[2] - pi[2]
    d_t = Rm.T @ (rel_t - meas[:2])
    d_th = wrap(rel_th - meas[2])
    return np.array([d_t[0], d_t[1], d_th])


def lm_residual_jac(pose, lm, meas):
    """Residual + analytic A (2x3), B (2x2) for a range-bearing edge."""
    R = rot(pose[2])
    pred = R.T @ (lm - pose[:2])
    local = np.array([meas[0] * np.cos(meas[1]), meas[0] * np.sin(meas[1])])
    r = pred - local
    c, s = np.cos(pose[2]), np.sin(pose[2])
    x1, y1 = pose[0], pose[1]
    A = np.array(
        [
            [-c, -s, c * lm[1] - s * lm[0] - c * y1 + s * x1],
            [s, -c, -s * lm[1] - c * lm[0] + s * y1 + c * x1],
        ]
    )
    B = R.T
    return r, A, B


def huber(chi2, delta=1.5):
    if chi2 <= delta * delta:
        return chi2, 1.0
    sq = np.sqrt(chi2)
    return 2 * sq * delta - delta * delta, delta / sq


def assemble_dense(
    poses,
    landmarks,
    odom_edges,
    lm_edges,
    pose_fixed,
    lm_fixed,
    huber_delta=1.5,
    fixed_prior=1e6,
):
    """Reference-semantics dense H/b from explicit edge lists.

    odom_edges: list of (i, j, meas3, info3x3)
    lm_edges:   list of (pose_idx, lm_idx, meas2, info2x2)
    Returns H, b, total robust error.  No padding handling — caller passes
    only real vertices/edges.
    """
    n, m = len(poses), len(landmarks)
    D = 3 * n + 2 * m
    H = np.zeros((D, D))
    b = np.zeros(D)
    err = 0.0

    def p_off(i):
        return 3 * i

    def l_off(k):
        return 3 * n + 2 * k

    for i, j, meas, info in odom_edges:
        r = odom_residual(poses[i], poses[j], meas)
        A, B = -np.eye(3), np.eye(3)
        chi2 = r @ info @ r
        er, w = huber(chi2, huber_delta)
        W = info * w
        oi, oj = p_off(i), p_off(j)
        H[oi : oi + 3, oi : oi + 3] += A.T @ W @ A
        H[oj : oj + 3, oj : oj + 3] += B.T @ W @ B
        H[oi : oi + 3, oj : oj + 3] += A.T @ W @ B
        H[oj : oj + 3, oi : oi + 3] += B.T @ W @ A
        b[oi : oi + 3] += A.T @ W @ r
        b[oj : oj + 3] += B.T @ W @ r
        err += er

    for p, k, meas, info in lm_edges:
        r, A, B = lm_residual_jac(poses[p], landmarks[k], meas)
        chi2 = r @ info @ r
        er, w = huber(chi2, huber_delta)
        W = info * w
        op, ol = p_off(p), l_off(k)
        H[op : op + 3, op : op + 3] += A.T @ W @ A
        H[ol : ol + 2, ol : ol + 2] += B.T @ W @ B
        H[op : op + 3, ol : ol + 2] += A.T @ W @ B
        H[ol : ol + 2, op : op + 3] += B.T @ W @ A
        b[op : op + 3] += A.T @ W @ r
        b[ol : ol + 2] += B.T @ W @ r
        err += er

    for i in range(n):
        if pose_fixed[i]:
            o = p_off(i)
            H[o : o + 3, o : o + 3] += np.eye(3) * fixed_prior
            b[o : o + 3] = 0.0
    for k in range(m):
        if lm_fixed[k]:
            o = l_off(k)
            H[o : o + 2, o : o + 2] += np.eye(2) * fixed_prior
            b[o : o + 2] = 0.0

    return H, b, err


def make_random_problem(rng, n_poses=12, n_lms=9, n_lm_edges=40):
    """A small consistent-but-noisy pose-landmark problem."""
    poses_gt = np.stack(
        [
            np.linspace(0, 5, n_poses),
            0.3 * np.sin(np.linspace(0, 3, n_poses)),
            np.linspace(0, 1.2, n_poses),
        ],
        axis=1,
    )
    lms_gt = rng.uniform(-2, 7, size=(n_lms, 2))

    odom_info = np.diag([4.0, 4.0, 60.0])
    lm_info = np.diag([44.0, 44.0])

    odom_edges = []
    for i in range(n_poses - 1):
        Ri = rot(poses_gt[i, 2])
        rel_t = Ri.T @ (poses_gt[i + 1, :2] - poses_gt[i, :2])
        rel_th = wrap(poses_gt[i + 1, 2] - poses_gt[i, 2])
        meas = np.array([rel_t[0], rel_t[1], rel_th]) + rng.normal(
            0, [0.03, 0.03, 0.01]
        )
        odom_edges.append((i, i + 1, meas, odom_info))

    lm_edges = []
    for _ in range(n_lm_edges):
        p = rng.integers(0, n_poses)
        k = rng.integers(0, n_lms)
        R = rot(poses_gt[p, 2])
        local = R.T @ (lms_gt[k] - poses_gt[p, :2])
        local = local + rng.normal(0, 0.05, size=2)
        meas = np.array(
            [np.linalg.norm(local), np.arctan2(local[1], local[0])]
        )
        lm_edges.append((p, k, meas, lm_info))

    poses0 = poses_gt + rng.normal(0, [0.2, 0.2, 0.05], size=poses_gt.shape)
    poses0[0] = poses_gt[0]
    lms0 = lms_gt + rng.normal(0, 0.3, size=lms_gt.shape)
    pose_fixed = np.zeros(n_poses, bool)
    pose_fixed[0] = True
    lm_fixed = np.zeros(n_lms, bool)
    return dict(
        poses_gt=poses_gt,
        lms_gt=lms_gt,
        poses0=poses0,
        lms0=lms0,
        odom_edges=odom_edges,
        lm_edges=lm_edges,
        pose_fixed=pose_fixed,
        lm_fixed=lm_fixed,
    )


def problem_to_builder(prob, pose_bucket=16, landmark_bucket=16, edge_bucket=32):
    from toyslam_tpu.models.graph import GraphBuilder2D

    b = GraphBuilder2D(
        pose_bucket=pose_bucket,
        landmark_bucket=landmark_bucket,
        edge_bucket=edge_bucket,
    )
    for p, fx in zip(prob["poses0"], prob["pose_fixed"]):
        b.add_pose(p, fixed=bool(fx))
    for k, (lm, fx) in enumerate(zip(prob["lms0"], prob["lm_fixed"])):
        b.add_landmark(k, lm, fixed=bool(fx))
    for i, j, meas, info in prob["odom_edges"]:
        b.add_odom_edge(i, j, meas, info)
    for p, k, meas, info in prob["lm_edges"]:
        b.add_landmark_edge(p, k, meas, info)
    return b

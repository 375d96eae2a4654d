"""The XLA Schur/PCG solve against a dense float64 solve of the same damped
system, for every preconditioner, on a chain graph and on the same graph
with loop-closure odometry edges."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest

from toyslam_tpu.ops import schur
from toyslam_tpu.ops.gather_plan import attach_plan
from toyslam_tpu.sim import synthetic

LAM = 1e-3


@pytest.fixture(scope="module")
def chain_graph():
    graph, _, _ = synthetic.make_large_problem(
        num_poses=200, num_landmarks=150, obs_per_pose=5, seed=0,
        pose_bucket=64, landmark_bucket=64, edge_bucket=256,
    )
    return attach_plan(graph)


@pytest.fixture(scope="module")
def closure_graph(chain_graph):
    """chain_graph plus two loop-closure odometry edges written into
    padded slots."""
    odom = chain_graph.odom
    i = np.asarray(odom.i).copy()
    j = np.asarray(odom.j).copy()
    mask = np.asarray(odom.mask).copy()
    meas = np.asarray(odom.meas).copy()
    info = np.asarray(odom.info).copy()
    slots = np.nonzero(mask == 0)[0][:2]
    for k, (a, b) in zip(slots, [(10, 120), (30, 180)]):
        i[k], j[k], mask[k] = a, b, 1.0
        meas[k] = [0.1, 0.05, 0.02]
        info[k] = np.diag([4.0, 4.0, 20.0])
    g = dataclasses.replace(
        chain_graph,
        odom=dataclasses.replace(
            odom, i=i, j=j, mask=mask, meas=meas, info=info
        ),
        plan=None,
    )
    return attach_plan(g)


def _dense_solve_f64(sys, graph):
    """``(H + lam I) dx = -b`` in float64, H assembled densely from the
    same float32 blocks the PCG operator reads."""
    n, m = graph.num_poses, graph.num_landmarks
    blk = {k: np.asarray(v, np.float64) for k, v in sys._asdict().items()}
    d = 3 * n + 2 * m
    h = np.zeros((d, d))
    p3 = 3 * np.arange(n)[:, None] + np.arange(3)
    np.add.at(h, (p3[:, :, None], p3[:, None, :]), blk["hpp_diag"])
    oi = 3 * np.asarray(graph.odom.i)[:, None] + np.arange(3)
    oj = 3 * np.asarray(graph.odom.j)[:, None] + np.arange(3)
    np.add.at(h, (oi[:, :, None], oj[:, None, :]), blk["hpp_off"])
    np.add.at(h, (oj[:, :, None], oi[:, None, :]),
              np.swapaxes(blk["hpp_off"], -1, -2))
    l2 = 3 * n + 2 * np.arange(m)[:, None] + np.arange(2)
    np.add.at(h, (l2[:, :, None], l2[:, None, :]), blk["hll"])
    ep = 3 * np.asarray(graph.lm_edges.pose)[:, None] + np.arange(3)
    el = 3 * n + 2 * np.asarray(graph.lm_edges.lm)[:, None] + np.arange(2)
    np.add.at(h, (ep[:, :, None], el[:, None, :]), blk["hpl"])
    np.add.at(h, (el[:, :, None], ep[:, None, :]),
              np.swapaxes(blk["hpl"], -1, -2))
    h += LAM * np.eye(d)
    b = np.concatenate([blk["bp"].ravel(), blk["bl"].ravel()])
    dx = np.linalg.solve(h, -b)
    return dx[: 3 * n].reshape(n, 3), dx[3 * n:].reshape(m, 2)


@pytest.mark.parametrize("which", ["chain", "closure"])
@pytest.mark.parametrize(
    "precond",
    ["jacobi", "tridiag", "chunk",
     "jacobi+coarse", "tridiag+coarse", "chunk+coarse"],
)
def test_pcg_matches_dense_f64(request, which, precond):
    graph = request.getfixturevalue(f"{which}_graph")
    sys = schur.assemble_blocks(graph, huber_delta=1.5)
    ref_p, ref_l = _dense_solve_f64(sys, graph)
    dx_p, dx_l, stats = schur.schur_solve(
        sys, graph, jnp.asarray(LAM, jnp.float32), tol=1e-6,
        max_iters=1000, precond=precond, coarse_group=32, chunk=32,
    )
    # PCG stops at a 1e-6 relative residual of the reduced system, whose
    # condition number lets the f32 step differ from the exact f64 solve
    # by up to ~1e-4 relative (3e-6 to 8e-5 on the chain graph)
    for got, want in ((dx_p, ref_p), (dx_l, ref_l)):
        rel = np.linalg.norm(np.asarray(got) - want) / np.linalg.norm(want)
        assert rel < 2e-4, (precond, which, rel, int(stats.pcg_iters))

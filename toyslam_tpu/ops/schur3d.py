"""Block-sparse SE(3) BA normal equations: assembly + Schur/PCG solve.

3D analogue of ops/schur.py's ``assemble_blocks`` — pose blocks are 6-dof
(dt, omega), landmark blocks 3-dof, reprojection edges couple them.  The
*solver* machinery (damping, Schur landmark elimination, block-Jacobi PCG,
dual-layout plan operator, psum hooks) is shared with the 2D path: every
function in ops/schur.py past assembly reads block sizes off the arrays, so
``schur.schur_solve`` runs unchanged on the 6/3 systems built here (the
3x3 landmark pivots invert through ``schur.inv3x3``).

The reference has no 3D capability at all (its roadmap names it, reference
README.md:52-56); its dense-QR design would cap out at ~1k poses anyway —
this path is O(N·36 + M·9 + E·18) memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.models.graph3d import FactorGraph3D
from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import edge_blocks3d as eb3
from toyslam_tpu.ops import residuals3d as res3
from toyslam_tpu.ops import schur
from toyslam_tpu.ops.schur import BlockSystem, _maybe_psum, _vertex_sum


def assemble_blocks_3d(
    graph: FactorGraph3D,
    huber_delta: float,
    fixed_prior: float = 1e6,
    exact_odom_jacobians: bool = False,
    axis_name: str | None = None,
) -> BlockSystem:
    """Sparse 6/3 block system for the SE(3) BA problem."""
    n, m = graph.num_poses, graph.num_landmarks

    od = res3.eval_odom3d_edges(
        graph.poses,
        graph.odom.i,
        graph.odom.j,
        graph.odom.meas,
        graph.odom.info,
        graph.odom.mask,
        huber_delta,
        exact=exact_odom_jacobians,
    )
    rb = eb3.reproj_edge_blocks(
        graph.poses,
        graph.landmarks,
        graph.intrinsics,
        graph.lm_edges.pose,
        graph.lm_edges.lm,
        graph.lm_edges.meas,
        graph.lm_edges.info,
        graph.lm_edges.mask,
        huber_delta,
    )

    w_od = od.w[:, None, None] * graph.odom.info        # [E1,6,6]

    plan = graph.plan
    t_oi = plan.odom_by_i if plan is not None else None
    t_oj = plan.odom_by_j if plan is not None else None
    t_lp = plan.lm_by_pose if plan is not None else None
    t_ll = plan.lm_by_lm if plan is not None else None

    # --- relative-pose contributions ----------------------------------
    ata = bm.quad(od.JA, w_od)
    btb = bm.quad(od.JB, w_od)
    atb = bm.mtm(od.JA, bm.mm(w_od, od.JB))
    wr = bm.mv(w_od, od.r)
    bp = _vertex_sum(bm.mtv(od.JA, wr), graph.odom.i, n, t_oi)
    bp = bp + _vertex_sum(bm.mtv(od.JB, wr), graph.odom.j, n, t_oj)
    hpp_diag = _vertex_sum(ata, graph.odom.i, n, t_oi)
    hpp_diag = hpp_diag + _vertex_sum(btb, graph.odom.j, n, t_oj)
    hpp_off = atb

    # --- reprojection contributions ------------------------------------
    hpp_diag = hpp_diag + _vertex_sum(
        rb.w_ata, graph.lm_edges.pose, n, t_lp
    )
    hll = _vertex_sum(rb.w_btb, graph.lm_edges.lm, m, t_ll)
    hpl = rb.w_hpl                                      # [E2,6,3]
    bp = bp + _vertex_sum(rb.bp_c, graph.lm_edges.pose, n, t_lp)
    bl = _vertex_sum(rb.bl_c, graph.lm_edges.lm, m, t_ll)

    hpp_diag = _maybe_psum(hpp_diag, axis_name)
    hll = _maybe_psum(hll, axis_name)
    bp = _maybe_psum(bp, axis_name)
    bl = _maybe_psum(bl, axis_name)

    # --- gauge priors + padding regularization -------------------------
    eye6 = jnp.eye(6, dtype=hpp_diag.dtype)
    eye3 = jnp.eye(3, dtype=hll.dtype)
    pose_reg = fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye6
    hll = hll + lm_reg[:, None, None] * eye3
    bp = bp * (1.0 - graph.pose_fixed)[:, None]
    bl = bl * (1.0 - graph.lm_fixed)[:, None]

    err = _maybe_psum(
        jnp.sum(od.robust_err) + jnp.sum(rb.robust_err), axis_name
    )
    return BlockSystem(
        hpp_diag=hpp_diag, hpp_off=hpp_off, hll=hll, hpl=hpl,
        bp=bp, bl=bl, err=err,
    )


def total_error_3d(
    graph: FactorGraph3D,
    huber_delta: float,
    exact_odom_jacobians: bool = False,
) -> jax.Array:
    """Robustified chi^2 of the current state (residuals only, no solve) —
    the cheap evaluation LM step control needs (config.reject_worse_steps)."""
    od = res3.eval_odom3d_edges(
        graph.poses,
        graph.odom.i,
        graph.odom.j,
        graph.odom.meas,
        graph.odom.info,
        graph.odom.mask,
        huber_delta,
        exact=False,  # Jacobians unused; skip the autodiff pass
    )
    rp = res3.eval_reproj_edges(
        graph.poses,
        graph.landmarks,
        graph.intrinsics,
        graph.lm_edges.pose,
        graph.lm_edges.lm,
        graph.lm_edges.meas,
        graph.lm_edges.info,
        graph.lm_edges.mask,
        huber_delta,
    )
    return jnp.sum(od.robust_err) + jnp.sum(rp.robust_err)


def schur3d_linearize_solve(cfg: OptimizerConfig, axis_name: str | None = None):
    """LinearizeSolve for SE(3) graphs, plugging into GaussNewton with
    ``retract=se3.retract``.  Returns (dx_poses [N,6], dx_lms [M,3], err)."""

    def solve(graph: FactorGraph3D, lam: jax.Array):
        sys = assemble_blocks_3d(
            graph,
            huber_delta=cfg.huber_delta,
            fixed_prior=cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians,
            axis_name=axis_name,
        )
        dx_p, dx_l, stats = schur.schur_solve(
            sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters, axis_name,
            cfg.pcg_restart_every, cfg.pcg_precond, cfg.pcg_coarse_group,
            chunk=cfg.pcg_chunk,
        )
        return dx_p, dx_l, sys.err, stats

    return solve

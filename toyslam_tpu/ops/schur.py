"""Block-sparse normal equations with Schur-complement landmark elimination.

The reference always materializes a dense ``D x D`` Hessian and solves it
with dense QR/LU (python/optimizer/graph_optimizer.py:105,64; CUDA dense QR
remote/cuda/solver/SolverCudaQr.h:44-81) — O(D^2) memory caps it at small
graphs.  SLAM Hessians are block-sparse with an arrowhead structure: the
landmark-landmark block ``Hll`` is block-diagonal (2x2 per landmark), so
landmarks can be eliminated locally and the reduced pose system

    S = Hpp - Hpl Hll^-1 Hlp,     S dx_p = -b_p + Hpl Hll^-1 b_l

solved by preconditioned conjugate gradients with a *matrix-free* matvec:
``S x`` only needs per-edge 3x3/3x2 block products and deterministic
``segment_sum`` scatters — never a dense matrix.  This is the scaling path
for the ~10k-pose configs and the unit of distribution (each device owns a
shard of edges/landmarks; ``S x`` partials reduce over the mesh — see
``parallel/distributed.py``).

Memory: O(N·9 + M·4 + E1·9 + E2·6) floats — linear in the graph.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.models.graph import FactorGraph2D
from toyslam_tpu.ops import edge_blocks
from toyslam_tpu.ops import gather_plan as gp
from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops.precision import einsum
from toyslam_tpu.ops import residuals as res_ops


def _vertex_sum(values, ids, num, table):
    """Per-vertex reduction of per-edge values.

    Uses the scatter-free gather table when the graph carries a GatherPlan
    (ops/gather_plan.py) — no atomics, a fixed sum order — and falls
    back to segment_sum (needed under shard_map, where tables would index
    sharded edge arrays).
    """
    if table is not None:
        return gp.table_sum(values, table)
    return jax.ops.segment_sum(values, ids, num)


def _maybe_psum(x, axis_name):
    """psum when running inside shard_map; identity single-device.

    Every reduction in this module that crosses the edge/landmark shard
    boundary funnels through here, so the identical code path serves one
    chip or a whole mesh (parallel/distributed.py).
    """
    if axis_name is None:
        return x
    return jax.lax.psum(x, axis_name)


class BlockSystem(NamedTuple):
    """Undamped block-sparse normal equations (gauge priors included)."""

    hpp_diag: jax.Array   # f32[N,3,3] pose diagonal blocks
    hpp_off: jax.Array    # f32[E1,3,3] odometry off-diagonal block at (i, j)
    hll: jax.Array        # f32[M,2,2] landmark diagonal blocks
    hpl: jax.Array        # f32[E2,3,2] pose-landmark coupling block per edge
    bp: jax.Array         # f32[N,3] pose gradient
    bl: jax.Array         # f32[M,2] landmark gradient
    err: jax.Array        # f32[] robust chi^2


def assemble_blocks(
    graph: FactorGraph2D,
    huber_delta: float,
    fixed_prior: float = 1e6,
    exact_odom_jacobians: bool = False,
    axis_name: str | None = None,
) -> BlockSystem:
    """Same math as ops/assemble.py but materializing only the sparse blocks.

    Per-edge linearization goes through ops/edge_blocks.py.  With
    ``axis_name`` set (inside shard_map,
    edge arrays sharded), the per-vertex reductions are psum'd so every
    device holds the complete diagonal blocks/gradients while the
    off-diagonal per-edge blocks (``hpp_off``, ``hpl``) stay shard-local.
    """
    n, m = graph.num_poses, graph.num_landmarks

    plan = graph.plan
    t_oi = plan.odom_by_i if plan is not None else None
    t_oj = plan.odom_by_j if plan is not None else None
    t_lp = plan.lm_by_pose if plan is not None else None
    t_ll = plan.lm_by_lm if plan is not None else None

    # --- odometry contributions --------------------------------------
    if exact_odom_jacobians:
        # General Jacobians: keep the full-formula path (non-default mode;
        # the A=-I/B=I structure below does not apply).
        od = res_ops.eval_odom_edges(
            graph.poses,
            graph.odom.i,
            graph.odom.j,
            graph.odom.meas,
            graph.odom.info,
            graph.odom.mask,
            huber_delta,
            exact=True,
        )
        w_od = od.w[:, None, None] * graph.odom.info      # [E1,3,3]
        ata = bm.quad(od.JA, w_od)
        btb = bm.quad(od.JB, w_od)
        atb = bm.mtm(od.JA, bm.mm(w_od, od.JB))
        wr_i = bm.mtv(od.JA, bm.mv(w_od, od.r))
        wr_j = bm.mtv(od.JB, bm.mv(w_od, od.r))
        odom_err = jnp.sum(od.robust_err)
    else:
        ob = edge_blocks.odom_edge_blocks(
            graph.poses,
            graph.odom.i,
            graph.odom.j,
            graph.odom.meas,
            graph.odom.info,
            graph.odom.mask,
            huber_delta,
        )
        # A=-I, B=I collapses every product to ±W' (KernelSe2.cu exploits
        # the same structure on the reference's CUDA path).
        ata = ob.w_info
        btb = ob.w_info
        atb = -ob.w_info
        wr_i = -ob.wr
        wr_j = ob.wr
        odom_err = jnp.sum(ob.robust_err)

    bp = _vertex_sum(wr_i, graph.odom.i, n, t_oi)
    bp = bp + _vertex_sum(wr_j, graph.odom.j, n, t_oj)
    hpp_diag = _vertex_sum(ata, graph.odom.i, n, t_oi)
    hpp_diag = hpp_diag + _vertex_sum(btb, graph.odom.j, n, t_oj)
    hpp_off = atb

    # --- landmark contributions --------------------------------------
    lb = edge_blocks.lm_edge_blocks(
        graph.poses,
        graph.landmarks,
        graph.lm_edges.pose,
        graph.lm_edges.lm,
        graph.lm_edges.meas,
        graph.lm_edges.info,
        graph.lm_edges.mask,
        huber_delta,
    )
    hpl = lb.w_hpl                                                # [E2,3,2]
    hpp_diag = hpp_diag + _vertex_sum(lb.w_ata, graph.lm_edges.pose, n, t_lp)
    hll = _vertex_sum(lb.w_btb, graph.lm_edges.lm, m, t_ll)
    bp = bp + _vertex_sum(lb.bp_c, graph.lm_edges.pose, n, t_lp)
    bl = _vertex_sum(lb.bl_c, graph.lm_edges.lm, m, t_ll)

    # Cross-shard reduction of everything indexed per-vertex; per-edge
    # blocks stay local to their shard.
    hpp_diag = _maybe_psum(hpp_diag, axis_name)
    hll = _maybe_psum(hll, axis_name)
    bp = _maybe_psum(bp, axis_name)
    bl = _maybe_psum(bl, axis_name)

    # --- gauge priors + padding regularization -----------------------
    eye3 = jnp.eye(3, dtype=hpp_diag.dtype)
    eye2 = jnp.eye(2, dtype=hll.dtype)
    pose_reg = fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye3
    hll = hll + lm_reg[:, None, None] * eye2
    bp = bp * (1.0 - graph.pose_fixed)[:, None]
    bl = bl * (1.0 - graph.lm_fixed)[:, None]

    err = _maybe_psum(odom_err + jnp.sum(lb.robust_err), axis_name)
    return BlockSystem(
        hpp_diag=hpp_diag, hpp_off=hpp_off, hll=hll, hpl=hpl,
        bp=bp, bl=bl, err=err,
    )


def damp(sys: BlockSystem, lam: jax.Array) -> BlockSystem:
    """Add ``lam I`` to every diagonal, matching the dense path's
    ``H + lam*eye(D)`` (graph_optimizer.py:43).  Block sizes are read off
    the arrays, so the same code damps 3/2 (SE(2)) and 6/3 (SE(3)) systems.
    """
    eye_p = jnp.eye(sys.hpp_diag.shape[-1], dtype=sys.hpp_diag.dtype)
    eye_l = jnp.eye(sys.hll.shape[-1], dtype=sys.hll.dtype)
    return sys._replace(
        hpp_diag=sys.hpp_diag + lam * eye_p,
        hll=sys.hll + lam * eye_l,
    )


def inv2x2(blocks: jax.Array) -> jax.Array:
    """Closed-form batched 2x2 inverse — the Schur pivot."""
    a = blocks[..., 0, 0]
    b = blocks[..., 0, 1]
    c = blocks[..., 1, 0]
    d = blocks[..., 1, 1]
    det = a * d - b * c
    inv_det = 1.0 / det
    row0 = jnp.stack([d * inv_det, -b * inv_det], axis=-1)
    row1 = jnp.stack([-c * inv_det, a * inv_det], axis=-1)
    return jnp.stack([row0, row1], axis=-2)


def inv3x3(blocks: jax.Array) -> jax.Array:
    """Closed-form batched 3x3 inverse via the adjugate (elementwise —
    no LAPACK-style factorization for tiny blocks)."""
    m = blocks
    c00 = m[..., 1, 1] * m[..., 2, 2] - m[..., 1, 2] * m[..., 2, 1]
    c01 = m[..., 1, 2] * m[..., 2, 0] - m[..., 1, 0] * m[..., 2, 2]
    c02 = m[..., 1, 0] * m[..., 2, 1] - m[..., 1, 1] * m[..., 2, 0]
    c10 = m[..., 0, 2] * m[..., 2, 1] - m[..., 0, 1] * m[..., 2, 2]
    c11 = m[..., 0, 0] * m[..., 2, 2] - m[..., 0, 2] * m[..., 2, 0]
    c12 = m[..., 0, 1] * m[..., 2, 0] - m[..., 0, 0] * m[..., 2, 1]
    c20 = m[..., 0, 1] * m[..., 1, 2] - m[..., 0, 2] * m[..., 1, 1]
    c21 = m[..., 0, 2] * m[..., 1, 0] - m[..., 0, 0] * m[..., 1, 2]
    c22 = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
    det = (
        m[..., 0, 0] * c00 + m[..., 0, 1] * c01 + m[..., 0, 2] * c02
    )
    inv_det = 1.0 / det
    rows = [
        jnp.stack([c00, c10, c20], axis=-1),
        jnp.stack([c01, c11, c21], axis=-1),
        jnp.stack([c02, c12, c22], axis=-1),
    ]
    return jnp.stack(rows, axis=-2) * inv_det[..., None, None]


def inv_blocks(blocks: jax.Array) -> jax.Array:
    """Batched small-block inverse: closed forms for 2x2/3x3 (the SE(2) and
    SE(3) landmark pivots), generic solve otherwise."""
    k = blocks.shape[-1]
    if k == 2:
        return inv2x2(blocks)
    if k == 3:
        return inv3x3(blocks)
    return jnp.linalg.inv(blocks)


def hpp_matvec(
    sys: BlockSystem, odom_i: jax.Array, odom_j: jax.Array, x: jax.Array,
    axis_name: str | None = None, plan=None,
) -> jax.Array:
    """``Hpp @ x`` for ``x [N, 3]`` using only blocks.

    ``sys.hpp_diag`` is replicated-complete; the off-diagonal products run
    over the local edge shard and reduce across the mesh.
    """
    n = x.shape[0]
    t_oi = plan.odom_by_i if plan is not None else None
    t_oj = plan.odom_by_j if plan is not None else None
    off = _vertex_sum(
        bm.mv(sys.hpp_off, x[odom_j]), odom_i, n, t_oi
    )
    off = off + _vertex_sum(
        bm.mtv(sys.hpp_off, x[odom_i]), odom_j, n, t_oj
    )
    return bm.mv(sys.hpp_diag, x) + _maybe_psum(
        off, axis_name
    )


def hlp_matvec(
    sys: BlockSystem, lm_pose: jax.Array, lm_lm: jax.Array, x: jax.Array,
    num_landmarks: int,
    axis_name: str | None = None,
    plan=None,
) -> jax.Array:
    """``Hlp @ x = Hpl^T @ x`` -> [M, 2]."""
    t_ll = plan.lm_by_lm if plan is not None else None
    return _maybe_psum(
        _vertex_sum(
            bm.mtv(sys.hpl, x[lm_pose]), lm_lm,
            num_landmarks, t_ll,
        ),
        axis_name,
    )


def hpl_matvec(
    sys: BlockSystem, lm_pose: jax.Array, lm_lm: jax.Array, y: jax.Array,
    num_poses: int,
    axis_name: str | None = None,
    plan=None,
) -> jax.Array:
    """``Hpl @ y`` for ``y [M, 2]`` -> [N, 3]."""
    t_lp = plan.lm_by_pose if plan is not None else None
    return _maybe_psum(
        _vertex_sum(
            bm.mv(sys.hpl, y[lm_lm]), lm_pose, num_poses, t_lp
        ),
        axis_name,
    )


def schur_matvec(
    sys: BlockSystem,
    hll_inv: jax.Array,
    graph: FactorGraph2D,
    x: jax.Array,
    axis_name: str | None = None,
) -> jax.Array:
    """``S @ x`` without materializing S."""
    u = hlp_matvec(sys, graph.lm_edges.pose, graph.lm_edges.lm, x,
                   graph.num_landmarks, axis_name, graph.plan)
    v = bm.mv(hll_inv, u)
    w = hpl_matvec(sys, graph.lm_edges.pose, graph.lm_edges.lm, v,
                   graph.num_poses, axis_name, graph.plan)
    return hpp_matvec(sys, graph.odom.i, graph.odom.j, x, axis_name,
                      graph.plan) - w


def schur_s_diag(
    sys: BlockSystem, hll_inv: jax.Array, graph: FactorGraph2D,
    axis_name: str | None = None,
) -> jax.Array:
    """Diagonal blocks of S: ``[N, d, d]``.

    Exact when each (pose, landmark) pair is observed by a single edge
    (true for the per-frame frontend); an approximation (and a perfectly
    valid preconditioner seed) otherwise.
    """
    contrib = bm.mm(bm.mm(sys.hpl, hll_inv[graph.lm_edges.lm]),
                    jnp.swapaxes(sys.hpl, -1, -2))
    t_lp = graph.plan.lm_by_pose if graph.plan is not None else None
    return sys.hpp_diag - _maybe_psum(
        _vertex_sum(contrib, graph.lm_edges.pose, graph.num_poses, t_lp),
        axis_name,
    )


def schur_preconditioner(
    sys: BlockSystem, hll_inv: jax.Array, graph: FactorGraph2D,
    axis_name: str | None = None,
) -> jax.Array:
    """Inverse block-Jacobi of S: ``[N, d, d]`` (closed-form block inverse:
    elementwise, where ``jnp.linalg.inv`` runs a batched factorization)."""
    return inv_blocks(schur_s_diag(sys, hll_inv, graph, axis_name))


class PlanOperator(NamedTuple):
    """Damped Schur operator in dual per-vertex layout — zero per-edge
    gathers inside the PCG loop.

    The per-edge blocks (recomputed every linearization) are re-materialized
    once into landmark-major ``[M, Kl, ...]`` and pose-major ``[N, Kp, ...]``
    grids; a PCG matvec then reads only dense grids plus gathers of rows of
    the small state vectors ``x [N,3]`` / ``v [M,2]``.  Random row gathers
    over the big edge arrays were the PCG bottleneck (~1.4 ms/iter at 60k
    edges); this layout amortizes them into one relayout per GN iteration.
    """

    hpp_diag: jax.Array   # [N,3,3] damped
    hll_inv: jax.Array    # [M,2,2]
    hpl_L: jax.Array      # [M,Kl,3,2] masked blocks, landmark-major
    pose_L: jax.Array     # i32[M,Kl] observing pose per slot
    hpl_P: jax.Array      # [N,Kp,3,2] masked blocks, pose-major
    lm_P: jax.Array       # i32[N,Kp]
    off_I: jax.Array      # [N,Ko,3,3] odometry off-diag blocks at (i,.)
    j_I: jax.Array        # i32[N,Ko]
    off_J: jax.Array      # [N,Ko,3,3] blocks at (.,j) (transposed use)
    i_J: jax.Array        # i32[N,Ko]


def make_plan_operator(
    d: BlockSystem, hll_inv: jax.Array, graph: FactorGraph2D
) -> PlanOperator:
    plan = graph.plan
    lb, pb = plan.lm_by_lm, plan.lm_by_pose
    oi, oj = plan.odom_by_i, plan.odom_by_j
    return PlanOperator(
        hpp_diag=d.hpp_diag,
        hll_inv=hll_inv,
        hpl_L=d.hpl[lb.idx] * lb.mask[..., None, None],
        pose_L=graph.lm_edges.pose[lb.idx],
        hpl_P=d.hpl[pb.idx] * pb.mask[..., None, None],
        lm_P=graph.lm_edges.lm[pb.idx],
        off_I=d.hpp_off[oi.idx] * oi.mask[..., None, None],
        j_I=graph.odom.j[oi.idx],
        off_J=d.hpp_off[oj.idx] * oj.mask[..., None, None],
        i_J=graph.odom.i[oj.idx],
    )


def plan_matvec(
    op: PlanOperator, x: jax.Array, axis_name: str | None = None
) -> jax.Array:
    """``S @ x`` on the dual layout: dense grids + small state gathers.

    With ``axis_name`` set the grids hold each device's edge shard (built
    from per-shard gather tables, ops/gather_plan.py build_sharded_plan):
    the landmark intermediate ``u`` and the pose-space edge partials reduce
    across the mesh — two small psums ([M,dl] + [N,dp]) per matvec.
    ``hpp_diag``/``hll_inv`` are replicated-complete, so their terms
    stay outside the reductions.
    """
    u = jnp.sum(bm.mtv(op.hpl_L, x[op.pose_L]), axis=1)
    u = _maybe_psum(u, axis_name)
    v = bm.mv(op.hll_inv, u)
    w = jnp.sum(bm.mv(op.hpl_P, v[op.lm_P]), axis=1)
    off = (
        jnp.sum(bm.mv(op.off_I, x[op.j_I]), axis=1)
        + jnp.sum(bm.mtv(op.off_J, x[op.i_J]), axis=1)
    )
    return bm.mv(op.hpp_diag, x) + _maybe_psum(off - w, axis_name)


def plan_s_diag(
    op: PlanOperator, axis_name: str | None = None
) -> jax.Array:
    """Diagonal blocks of S from the pose-major grid (edge contributions
    psum across the mesh when sharded)."""
    hi = op.hll_inv[op.lm_P]
    contrib = jnp.sum(
        bm.mm(bm.mm(op.hpl_P, hi), jnp.swapaxes(op.hpl_P, -1, -2)), axis=1
    )
    return op.hpp_diag - _maybe_psum(contrib, axis_name)


def plan_preconditioner(op: PlanOperator) -> jax.Array:
    """Inverse block-Jacobi of S from the pose-major grid (closed form —
    see schur_preconditioner)."""
    return inv_blocks(plan_s_diag(op))


def _shift_down(x: jax.Array, s: int) -> jax.Array:
    """``y[i] = x[i-s]`` with zero fill (block arrays, axis 0)."""
    if s >= x.shape[0]:
        return jnp.zeros_like(x)
    return jnp.concatenate([jnp.zeros_like(x[:s]), x[:-s]], axis=0)


def _shift_up(x: jax.Array, s: int) -> jax.Array:
    """``y[i] = x[i+s]`` with zero fill."""
    if s >= x.shape[0]:
        return jnp.zeros_like(x)
    return jnp.concatenate([x[s:], jnp.zeros_like(x[:s])], axis=0)


class TridiagPrecond(NamedTuple):
    """Block-tridiagonal preconditioner factored by parallel cyclic
    reduction (PCR).

    Block-Jacobi ignores the pose-chain coupling entirely, so PCG
    information propagates one hop per iteration — on the 10k-pose chain it
    hits the iteration cap without converging (300 iterations, residual
    stuck at 1e3).  Taking M = the block-tridiagonal part of the
    Schur complement (exact S diagonal + the odometry-chain off-diagonal)
    and solving M z = r *exactly* each iteration collapses the chain: PCR
    decouples all N unknowns in ceil(log2 N) data-parallel levels of
    batched small-block algebra — no sequential Thomas sweep, every level
    is dense elementwise [N,d,d] work.

    ``alphas[l] / gammas[l]``: the level-``l`` elimination coefficients for
    the lower/upper neighbor at stride ``2^l``; ``binv``: the fully reduced
    (decoupled) diagonal, inverted.  Apply = L shift-multiply-adds on
    ``r`` followed by one block matvec.

    Stored in BLOCK layout ``[N, d, d]``: a plane-layout apply needs
    [N,d] <-> [d,N] state transposes every PCG iteration.  Only the BUILD
    runs in planes (build_tridiag_planes), where there is no per-iteration
    transpose to pay.
    """

    alphas: jax.Array  # [L, N, d, d]
    gammas: jax.Array  # [L, N, d, d]
    binv: jax.Array    # [N, d, d]


def _pl_shift_down(x: jax.Array, s: int) -> jax.Array:
    """Plane-layout ``y[..., v] = x[..., v - s]`` with zero fill."""
    if s >= x.shape[-1]:
        return jnp.zeros_like(x)
    return jnp.concatenate(
        [jnp.zeros_like(x[..., :s]), x[..., :-s]], axis=-1
    )


def _pl_shift_up(x: jax.Array, s: int) -> jax.Array:
    """Plane-layout ``y[..., v] = x[..., v + s]`` with zero fill."""
    if s >= x.shape[-1]:
        return jnp.zeros_like(x)
    return jnp.concatenate(
        [x[..., s:], jnp.zeros_like(x[..., :s])], axis=-1
    )


def _pl_mm(a: jax.Array, b: jax.Array) -> jax.Array:
    """Block product on component planes: [d,d,N] x [d,d,N] -> [d,d,N].

    Unrolled elementwise products on [N]-long vectors — einsum here lowers
    to a batched dot_general over a tiny 3x3 contraction (see
    ops/blockmath.py)."""
    d = a.shape[0]
    rows = [
        jnp.stack([
            sum(a[i, k] * b[k, j] for k in range(d))
            for j in range(d)
        ])
        for i in range(d)
    ]
    return jnp.stack(rows)


def _pl_t(a: jax.Array) -> jax.Array:
    """Blockwise transpose on planes."""
    return jnp.swapaxes(a, 0, 1)


def _pl_inv(p: jax.Array) -> jax.Array:
    """Closed-form inverse of 2x2/3x3 blocks in plane layout [d,d,N] —
    every intermediate is an [N]-long lane vector."""
    d = p.shape[0]
    if d == 2:
        a, b2 = p[0, 0], p[0, 1]
        c, e = p[1, 0], p[1, 1]
        inv_det = 1.0 / (a * e - b2 * c)
        return jnp.stack([
            jnp.stack([e, -b2]), jnp.stack([-c, a]),
        ]) * inv_det
    if d == 3:
        m = p
        c00 = m[1, 1] * m[2, 2] - m[1, 2] * m[2, 1]
        c01 = m[1, 2] * m[2, 0] - m[1, 0] * m[2, 2]
        c02 = m[1, 0] * m[2, 1] - m[1, 1] * m[2, 0]
        c10 = m[0, 2] * m[2, 1] - m[0, 1] * m[2, 2]
        c11 = m[0, 0] * m[2, 2] - m[0, 2] * m[2, 0]
        c12 = m[0, 1] * m[2, 0] - m[0, 0] * m[2, 1]
        c20 = m[0, 1] * m[1, 2] - m[0, 2] * m[1, 1]
        c21 = m[0, 2] * m[1, 0] - m[0, 0] * m[1, 2]
        c22 = m[0, 0] * m[1, 1] - m[0, 1] * m[1, 0]
        inv_det = 1.0 / (m[0, 0] * c00 + m[0, 1] * c01 + m[0, 2] * c02)
        return jnp.stack([
            jnp.stack([c00, c10, c20]),
            jnp.stack([c01, c11, c21]),
            jnp.stack([c02, c12, c22]),
        ]) * inv_det
    # generic fallback through the block layout
    return jnp.moveaxis(inv_blocks(jnp.moveaxis(p, -1, 0)), 0, -1)


def build_tridiag_planes(
    diag_p: jax.Array, upper_p: jax.Array
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """PCR factorization in COMPONENT-PLANE layout ``[d, d, N]``.

    Same elimination as the block-layout build below, but every
    intermediate is a stack of ``[N]``-long vectors instead of
    ``[N, d, d]`` tiny-trailing-dims arrays, so the factorization's ~100
    small ops per level each run over one long contiguous axis.  Returns
    ``(alphas [L,d,d,N], gammas [L,d,d,N], binv [d,d,N])``.
    """
    n = diag_p.shape[-1]
    levels = max(1, (n - 1).bit_length())
    a = _pl_t(_pl_shift_down(upper_p, 1))   # A[v] = upper[v-1]^T
    b = diag_p
    c = upper_p
    alphas, gammas = [], []
    s = 1
    for _ in range(levels):
        binv = _pl_inv(b)
        alpha = -_pl_mm(a, _pl_shift_down(binv, s))
        gamma = -_pl_mm(c, _pl_shift_up(binv, s))
        b = (
            b
            + _pl_mm(alpha, _pl_shift_down(c, s))
            + _pl_mm(gamma, _pl_shift_up(a, s))
        )
        a = _pl_mm(alpha, _pl_shift_down(a, s))
        c = _pl_mm(gamma, _pl_shift_up(c, s))
        alphas.append(alpha)
        gammas.append(gamma)
        s *= 2
    return jnp.stack(alphas), jnp.stack(gammas), _pl_inv(b)


def build_tridiag_precond(
    diag: jax.Array, upper: jax.Array
) -> TridiagPrecond:
    """Factor the block tridiagonal ``M = tridiag(upper^T, diag, upper)``.

    ``diag [N,d,d]``; ``upper[v] [N,d,d]`` is the (v, v+1) block (row v of
    the superdiagonal; the last row must be zero).  Boundary handling is by
    zero fill: out-of-range neighbors contribute zero coefficients.
    Internally runs in plane layout (build_tridiag_planes) and transposes
    at the boundary — two cheap transposes ONCE PER BUILD instead of ~100
    small-block ops per level on (N, d, d) layouts.
    """
    al, ga, binv = build_tridiag_planes(
        jnp.transpose(diag, (1, 2, 0)), jnp.transpose(upper, (1, 2, 0))
    )
    return TridiagPrecond(
        alphas=jnp.transpose(al, (0, 3, 1, 2)),
        gammas=jnp.transpose(ga, (0, 3, 1, 2)),
        binv=jnp.transpose(binv, (2, 0, 1)),
    )


def tridiag_apply(pre: TridiagPrecond, r: jax.Array) -> jax.Array:
    """Solve ``M z = r`` using the PCR factorization (exact up to f32)."""
    levels = pre.alphas.shape[0]
    s = 1
    for l in range(levels):
        r = (
            r
            + bm.mv(pre.alphas[l], _shift_down(r, s))
            + bm.mv(pre.gammas[l], _shift_up(r, s))
        )
        s *= 2
    return bm.mv(pre.binv, r)


def chain_upper(
    sys: BlockSystem, odom_i: jax.Array, odom_j: jax.Array, n: int,
    axis_name: str | None = None,
) -> jax.Array:
    """Superdiagonal of the pose-chain part of S: the odometry off-diagonal
    blocks of consecutive poses (loop-closure edges j != i+1 are excluded —
    they stay in S but not in the preconditioner).  Padded edges carry zero
    blocks already (masked at linearization)."""
    m = (odom_j == odom_i + 1).astype(sys.hpp_off.dtype)
    up = jax.ops.segment_sum(sys.hpp_off * m[:, None, None], odom_i, n)
    return _maybe_psum(up, axis_name)


def build_chunk_precond(
    diag: jax.Array, upper: jax.Array, chunk: int
) -> jax.Array:
    """Chunked block-Cholesky local preconditioner: the explicit inverse of
    the block-tridiagonal part of S restricted to contiguous ``chunk``-pose
    chunks (chain coupling across chunk boundaries is dropped — 1/chunk of
    the couplings; the coarse level owns the global modes anyway).

    Why it exists: the PCR tridiag apply is ceil(log2 N) *sequential*
    levels of small [N,d,d] ops (~6 ops/level, ~84 ops per PCG iteration
    at 10k poses), and a PCG loop of small ops is bound by per-op latency.
    This apply is ONE batched matmul ([nb, chunk*d, chunk*d] x
    [nb, chunk*d]) — a few extra PCG iterations for a ~40x op-count cut
    per iteration.

    Build: scatter the diag/upper blocks into ``[nb, chunk*d, chunk*d]``
    dense chunk matrices (row = t*d + a, t = pose within chunk), Jacobi
    equilibrate (the 1e6 gauge prior otherwise costs ~6 digits of the f32
    inverse), invert, un-equilibrate.  Ragged tail is padded with identity
    rows.  Replaces the same per-chip role as the reference's dense-QR
    solver (remote/cuda/solver/SolverCudaQr.h:44-81) at the
    preconditioner level.

    ``diag [N,d,d]``; ``upper[v] [N,d,d]`` = the (v, v+1) chain block (as
    from chain_upper).  Returns ``inv [nb, chunk*d, chunk*d]``.
    """
    n, dp, _ = diag.shape
    nb = -(-n // chunk)
    pad = nb * chunk - n
    t = jnp.arange(n)
    keep = ((t % chunk) != (chunk - 1)) & (t < n - 1)
    up = upper * keep[:, None, None].astype(upper.dtype)
    if pad:
        eye = jnp.broadcast_to(jnp.eye(dp, dtype=diag.dtype), (pad, dp, dp))
        diag = jnp.concatenate([diag, eye], axis=0)
        up = jnp.concatenate(
            [up, jnp.zeros((pad, dp, dp), up.dtype)], axis=0
        )
    sd = diag.reshape(nb, chunk, dp, dp)
    su = up.reshape(nb, chunk, dp, dp)
    kd = chunk * dp
    b = jnp.zeros((nb, kd, kd), diag.dtype)
    tl = jnp.arange(chunk)
    for a in range(dp):
        for c in range(dp):
            b = b.at[:, tl * dp + a, tl * dp + c].set(sd[:, :, a, c])
            b = b.at[:, tl[:-1] * dp + a, (tl[:-1] + 1) * dp + c].set(
                su[:, :-1, a, c]
            )
            b = b.at[:, (tl[:-1] + 1) * dp + a, tl[:-1] * dp + c].set(
                su[:, :-1, c, a]
            )
    # Jacobi equilibration: D^-1/2 B D^-1/2 has O(1) diagonal, so the f32
    # inverse keeps its digits even with the 1e6 gauge prior in chunk 0
    s = jax.lax.rsqrt(jnp.maximum(
        jnp.diagonal(b, axis1=-2, axis2=-1), 1e-30
    ))
    bs = b * s[:, :, None] * s[:, None, :]
    inv = jnp.linalg.inv(bs)
    return inv * s[:, :, None] * s[:, None, :]


def chunk_apply(inv: jax.Array, r: jax.Array) -> jax.Array:
    """``z = M^-1 r`` for the chunked preconditioner — one batched matmul.

    HIGHEST precision: M^-1 must stay symmetric-definite for PCG, and a
    TF32 product costs preconditioner quality for no latency win at these
    shapes.
    """
    n, dp = r.shape
    kd = inv.shape[-1]
    chunk = kd // dp
    nb = inv.shape[0]
    rp = jnp.pad(r, ((0, nb * chunk - n), (0, 0)))
    zb = jnp.einsum(
        "bij,bj->bi", inv, rp.reshape(nb, kd),
        precision=jax.lax.Precision.HIGHEST,
    )
    return zb.reshape(nb * chunk, dp)[:n]


def _block_pivot_floor(a: jax.Array) -> jax.Array:
    """Per-block pivot floor RELATIVE to the block's diagonal scale.

    An absolute 1e-30 floor let a clamped pivot produce ``l = 1e-15``
    whose divided column entries blew up to ~1e30/inf and propagated
    non-finite values into the fill terms — the failure mode the clamp
    was meant to fix, returning as inf.  ``eps * max(diag)``
    keeps clamped pivots on the block's own scale; combined with zeroing
    the sub-diagonal of a clamped column the factor stays bounded (it is
    the exact factor of a nearby SPD matrix, which is all the
    preconditioner fill terms need)."""
    scale = jnp.max(
        jnp.abs(jnp.diagonal(a, axis1=-2, axis2=-1)), axis=-1
    )
    return jnp.maximum(1.2e-7 * scale, 1e-30)


def _chol2x2(a: jax.Array) -> jax.Array:
    """Closed-form Cholesky of batched SPD 2x2 blocks (clamped pivots,
    see :func:`_block_pivot_floor`)."""
    tiny = _block_pivot_floor(a)
    d0 = a[..., 0, 0]
    s = jnp.sqrt(jnp.maximum(d0, tiny))
    l10 = jnp.where(d0 > tiny, a[..., 1, 0] / s, 0.0)
    l11 = jnp.sqrt(jnp.maximum(a[..., 1, 1] - l10 * l10, tiny))
    z = jnp.zeros_like(s)
    return jnp.stack(
        [jnp.stack([s, z], axis=-1), jnp.stack([l10, l11], axis=-1)],
        axis=-2,
    )


def _chol_small(a: jax.Array) -> jax.Array:
    """Batched Cholesky of tiny SPD blocks with clamped pivots — closed
    forms for 2x2/3x3.  ``jnp.linalg.cholesky`` NaNs on a pivot f32
    rounding pushes negative (observed on ill-conditioned BA landmark
    blocks: it made the partitioned SE(3) coarse build NaN); pivots are
    clamped relative to the block scale and the sub-diagonal of a clamped
    column is zeroed, so the result is the bounded, exact factor of a
    nearby SPD matrix."""
    k = a.shape[-1]
    if k == 2:
        return _chol2x2(a)
    if k == 3:
        tiny = _block_pivot_floor(a)
        d0 = a[..., 0, 0]
        ok0 = d0 > tiny
        l00 = jnp.sqrt(jnp.maximum(d0, tiny))
        l10 = jnp.where(ok0, a[..., 1, 0] / l00, 0.0)
        l20 = jnp.where(ok0, a[..., 2, 0] / l00, 0.0)
        d1 = a[..., 1, 1] - l10 * l10
        ok1 = d1 > tiny
        l11 = jnp.sqrt(jnp.maximum(d1, tiny))
        l21 = jnp.where(ok1, (a[..., 2, 1] - l20 * l10) / l11, 0.0)
        l22 = jnp.sqrt(
            jnp.maximum(a[..., 2, 2] - l20 * l20 - l21 * l21, tiny)
        )
        z = jnp.zeros_like(l00)
        return jnp.stack([
            jnp.stack([l00, z, z], -1),
            jnp.stack([l10, l11, z], -1),
            jnp.stack([l20, l21, l22], -1),
        ], -2)
    return jnp.linalg.cholesky(a)


def spd_inverse(
    sc: jax.Array, ns_iters: int | None = None, cond_bound: float = 2e4,
) -> jax.Array:
    """Explicit inverse of a dense SPD matrix by Jacobi equilibration +
    Newton-Schulz iteration — dense matmuls only, no sequential
    factorization:

        X_{k+1} = X_k (2 I - A X_k),   X_0 = I / ||A||_inf

    is 2 dense matmuls per step.  Every iterate is a polynomial
    in A, hence symmetric with eigenvalues in (0, 2/lambda) — the result
    is SPD at any iteration count, which is all a PCG preconditioner
    needs.  Jacobi equilibration first (D^-1/2 A D^-1/2 has unit
    diagonal) both bounds cond away from the 1e6 gauge prior's 3e-7
    spread and makes ||.||_inf a tight lambda_max bound.  HIGHEST matmul
    precision: the smallest eigenvalues of the equilibrated operator
    still sit ~1e-4 below the largest, under TF32's ~3 digits.

    The iteration count is DERIVED from the caller's condition bound
    (a fixed 24 silently under-converges past cond ~5e5):
    the slow phase contracts the extreme error mode ~2x per step, so
    ``ceil(log2(cond_bound)) + 10`` covers the slow phase plus the
    quadratic tail with margin.  Call sites boost the diagonal by 1e-4
    relative exactly so cond of the equilibrated system is ≤ ~1e4;
    ``cond_bound`` defaults to 2e4 for 2x margin.  An explicit
    ``ns_iters`` overrides.

    f32 envelope (measured, tests/test_schur.py): at equilibrated cond
    ~1e4 the converged residual ||I - A X||_max is ~8e-3; by cond ~3e6
    the f32 ROUNDING OF THE INPUT is itself an indefinite matrix, the
    one-sided NS drifts asymmetric (AX ~ I but XA far from I), and the
    final symmetrization degrades the residual by orders of magnitude —
    callers MUST bound cond via the diagonal boost, which every in-repo
    call site does.
    """
    if ns_iters is None:
        ns_iters = int(np.ceil(np.log2(cond_bound))) + 10
    s = jax.lax.rsqrt(jnp.maximum(
        jnp.diagonal(sc), 1e-30
    )).astype(sc.dtype)
    a = sc * s[:, None] * s[None, :]
    hi = jax.lax.Precision.HIGHEST
    lmax = jnp.max(jnp.sum(jnp.abs(a), axis=1))
    x = (1.0 / lmax) * jnp.eye(a.shape[0], dtype=a.dtype)
    two_eye = 2.0 * jnp.eye(a.shape[0], dtype=a.dtype)

    def body(_, x):
        return jnp.dot(x, two_eye - jnp.dot(a, x, precision=hi),
                       precision=hi)

    x = jax.lax.fori_loop(0, ns_iters, body, x)
    # rescale FIRST, symmetrize LAST: the final add makes the result
    # exactly symmetric; rescaling after it would let XLA fuse the two
    # multiplies in a per-side order that breaks bitwise symmetry
    x = x * (s[:, None] * s[None, :])
    return 0.5 * (x + x.T)


def build_coarse_precond(
    d: BlockSystem,
    hll_inv: jax.Array,
    graph: FactorGraph2D,
    group: int,
    axis_name: str | None = None,
) -> jax.Array:
    """Galerkin coarse-grid operator for the two-level preconditioner.

    Local preconditioners (block-Jacobi, the tridiag chain) propagate
    information one hop per PCG iteration, so the *smooth* error modes of a
    10k-pose graph (global drift) converge at O(diameter) iterations —
    389 iterations at tol 1e-3 even with the exact chain
    solve.  The standard cure is a coarse space: aggregate every ``group``
    consecutive poses into one super-pose (piecewise-constant restriction
    R) and solve the aggregated system ``S_c = R^T S R`` exactly.  S_c is
    built directly from the block pieces — never from matvecs:

      R^T Hpp R        — segment-sums of the diagonal/off-diagonal blocks
                         over group pairs (coarse graph is tiny: [Nc,Nc]);
      R^T Hpl Hll^-1 Hlp R — with U = R^T Hpl (one segment-sum over edges
                         per block component) and L = chol(Hll^-1):
                         V = U L, fill = V V^T — one matmul over the
                         [d*Nc, dl*M] flattening.

    The coarse system uses COMPONENT-MAJOR ordering (row = a*Nc + c, i.e.
    all x-components, then all y, then all theta) rather than the
    pose-major interleaving of the fine system: component-major lets every
    intermediate be a stack of [Nc, M] planes with two large dims, whereas
    pose-major needs a [Nc*M, d, dl] buffer with (3, 2) trailing dims,
    which layouts pad far beyond their payload at the 100k-pose scale.  Only build_coarse_precond and coarse_apply see
    the ordering; they agree by construction.

    Returns the dense EXPLICIT INVERSE of S_c ``[d*Nc, d*Nc]`` (Jacobi-
    equilibrated Newton-Schulz, see spd_inverse), so the apply is one
    matvec instead of two triangular solves.  Under shard_map the
    segment-sums reduce with psum, so every device holds the identical
    coarse inverse.
    """
    n, m = graph.num_poses, graph.num_landmarks
    dp = d.hpp_diag.shape[-1]
    dl = d.hll.shape[-1]
    # ceil-grouping: the last coarse aggregate may hold fewer than ``group``
    # poses (always >= 1), so any n works — 100k-scale runs pick group from
    # a target coarse size and n is rarely an exact multiple
    nc = -(-n // group)

    gid = jnp.arange(n, dtype=jnp.int32) // group
    gi = graph.odom.i // group
    gj = graph.odom.j // group
    hc = jax.ops.segment_sum(d.hpp_diag, gid * nc + gid, nc * nc)
    hc = hc + jax.ops.segment_sum(d.hpp_off, gi * nc + gj, nc * nc)
    hc = hc + jax.ops.segment_sum(
        jnp.swapaxes(d.hpp_off, -1, -2), gj * nc + gi, nc * nc
    )
    hc = _maybe_psum(hc, axis_name)
    sc = hc.reshape(nc, nc, dp, dp).transpose(2, 0, 3, 1).reshape(
        dp * nc, dp * nc
    )

    gp_e = graph.lm_edges.pose // group
    ids = gp_e * m + graph.lm_edges.lm
    vals = d.hpl.reshape(-1, dp * dl)
    u = [
        _maybe_psum(
            jax.ops.segment_sum(vals[:, k], ids, nc * m), axis_name
        ).reshape(nc, m)
        for k in range(dp * dl)
    ]
    el = _chol_small(hll_inv)  # [m, dl, dl] lower
    # V = U L, one [nc, m] plane per (row-component a, col-component b2)
    vf = jnp.concatenate([
        jnp.concatenate([
            sum(u[a * dl + b] * el[:, b, b2][None, :] for b in range(dl))
            for b2 in range(dl)
        ], axis=1)
        for a in range(dp)
    ], axis=0)  # [dp*nc, dl*m]
    # HIGHEST precision is mandatory: S_c's smallest eigenvalue is ~3e-7 of
    # its largest (the 1e6 gauge prior), far below what a reduced-precision
    # (TF32/bf16) product keeps: default precision can make S_c indefinite
    # and poison the whole solve.
    sc = sc - jnp.dot(vf, vf.T, precision=jax.lax.Precision.HIGHEST)
    # scale-relative jitter: SPD safety margin against f32 rounding without
    # affecting preconditioner quality
    didx = jnp.arange(sc.shape[0])
    sc = sc.at[didx, didx].add(1e-4 * sc[didx, didx])
    return spd_inverse(sc)


def coarse_apply(cinv: jax.Array, group: int, r: jax.Array) -> jax.Array:
    """``R S_c^{-1} R^T r`` — the coarse correction, [N, d] -> [N, d].

    ``cinv`` is the component-major explicit inverse (see
    build_coarse_precond), so the solve is ONE [dim, dim] matvec; the
    [nc, dp] transposes here are the tiny ordering shims."""
    n, dp = r.shape
    nc = -(-n // group)  # ceil, matching build_coarse_precond's ragged tail
    pad = nc * group - n
    rp = jnp.pad(r, ((0, pad), (0, 0)))
    rc = rp.reshape(nc, group, dp).sum(axis=1)          # [nc, dp]
    # HIGHEST: cinv spans the coarse operator's whole spectrum; a TF32
    # product (~3 digits) would perturb the correction far more than the
    # fine-level residual PCG is driving down
    zc = jnp.dot(cinv, rc.T.reshape(-1), precision=jax.lax.Precision.HIGHEST)
    z = zc.reshape(dp, nc).T                            # [nc, dp]
    return jnp.broadcast_to(
        z.reshape(nc, 1, dp), (nc, group, dp)
    ).reshape(nc * group, dp)[:n]


class PCGResult(NamedTuple):
    x: jax.Array
    iterations: jax.Array
    residual_norm: jax.Array


class SolveStats(NamedTuple):
    """Per-solve telemetry carried through the LinearizeSolve interface —
    the integrated analogue of the reference's BlockTimer breakdown
    (reference remote/tools/BlockTimer.cpp:6-19), as data instead of
    prints."""

    pcg_iters: jax.Array      # i32[] PCG iterations used (0 = direct solve)
    pcg_residual: jax.Array   # f32[] final PCG residual norm (0 = direct)

    @staticmethod
    def direct(dtype=jnp.float32) -> "SolveStats":
        return SolveStats(
            pcg_iters=jnp.asarray(0, jnp.int32),
            pcg_residual=jnp.asarray(0.0, dtype),
        )


def pcg(
    matvec, precond_apply, rhs: jax.Array, tol: float, max_iters: int,
    restart_every: int = 64, dot_axis_name: str | None = None,
    unroll: bool = False,
) -> PCGResult:
    """Preconditioned conjugate gradients over pose-space ``[N, d]`` arrays.

    Every operation is a fused batched block product or a reduction, so the
    loop jits to a tight on-device while_loop.

    **Residual replacement**: in float32 the recurrence residual drifts away
    from the true residual on ill-conditioned systems (measured on the SE(3)
    BA Schur complement, cond ~3e6: the recurrence "converges" while the
    true relative residual stalls at ~4e-2).  Every ``restart_every``
    iterations the true residual ``rhs - S x`` is recomputed and the search
    direction reset — one extra matvec per restart, bounding the drift.

    The loop is *chunked*: an inner fixed-trip loop of ``restart_every``
    plain PCG iterations, then one unconditional true-residual replacement
    between chunks.  The replacement must NOT live under ``lax.cond`` — the
    matvec carries a ``psum`` when distributed, and a collective inside a
    conditional silently mis-lowers under shard_map (observed: bitwise-
    correct matvec/rhs, garbage PCG iterates).  Unconditional structure
    keeps the collective schedule identical on every device.
    """

    def dot(a, b):
        # ``dot_axis_name`` set = the PCG state itself is sharded (the
        # partitioned path, parallel/partition.py): inner products psum
        # their local partials.  Replicated-state callers leave it None.
        return _maybe_psum(jnp.vdot(a, b), dot_axis_name)

    rhs_norm = jnp.sqrt(dot(rhs, rhs))
    atol2 = (tol * rhs_norm) ** 2
    n_chunks = -(-max_iters // restart_every)

    x0 = jnp.zeros_like(rhs)
    r0 = rhs
    z0 = precond_apply(r0)
    p0 = z0
    rz0 = dot(r0, z0)

    def inner(_, st):
        x, r, p, rz, it, stop = st
        ap = matvec(p)
        pap = dot(p, ap)
        # stop flags fold into a no-op update (alpha = beta = 0) so the
        # fixed-trip chunk is harmless after convergence/breakdown;
        # breakdown = f32 curvature lost positivity near the accuracy floor
        breakdown = ~(pap > 0.0) | ~jnp.isfinite(pap)
        done = stop | breakdown | (dot(r, r) <= atol2) | (it >= max_iters)
        alpha = jnp.where(done, jnp.zeros_like(rz), rz / pap)
        x = x + alpha * p
        r = r - alpha * ap
        z = precond_apply(r)
        rz_new = dot(r, z)
        safe_rz = jnp.where(rz == 0.0, jnp.ones_like(rz), rz)
        beta = jnp.where(done, jnp.zeros_like(rz), rz_new / safe_rz)
        p = jnp.where(done, p, z + beta * p)
        rz = jnp.where(done, rz, rz_new)
        return (x, r, p, rz, it + jnp.where(done, 0, 1), stop | breakdown)

    if unroll:
        # Measurement mode (scripts/bench_scaling_phases.py): exactly
        # ``max_iters`` trace-time-unrolled iterations of the identical
        # per-iteration op mix, no while_loop — XLA's cost_analysis counts
        # a while body once regardless of trip count, so the per-iteration
        # work decomposition needs the unrolled form.
        st = (x0, r0, p0, rz0, jnp.asarray(0, jnp.int32),
              jnp.asarray(False))
        for _ in range(max_iters):
            st = inner(0, st)
        x, r, p, rz, it, stop = st
        # 0*rz keeps the preconditioner BUILD live at max_iters=0 (the
        # "build"-phase measurement would otherwise DCE it away)
        return PCGResult(
            x=x, iterations=it,
            residual_norm=jnp.sqrt(dot(r, r)) + 0.0 * rz,
        )

    def cond(st):
        x, r, p, rz, it, stop, chunk = st
        return (chunk < n_chunks) & (dot(r, r) > atol2) & ~stop

    def chunk_body(st):
        x, r, p, rz, it, stop, chunk = st
        x, r, p, rz, it, stop = jax.lax.fori_loop(
            0, restart_every, inner, (x, r, p, rz, it, stop)
        )
        # unconditional residual replacement + direction restart: bounds
        # the f32 recurrence drift (true residual recomputed), and keeps
        # the matvec's collectives outside any conditional
        r = rhs - matvec(x)
        z = precond_apply(r)
        rz = dot(r, z)
        p = z
        return (x, r, p, rz, it, stop, chunk + 1)

    x, r, p, rz, it, stop, _ = jax.lax.while_loop(
        cond,
        chunk_body,
        (
            x0, r0, p0, rz0,
            jnp.asarray(0, jnp.int32),
            jnp.asarray(False),
            jnp.asarray(0, jnp.int32),
        ),
    )
    return PCGResult(x=x, iterations=it, residual_norm=jnp.sqrt(dot(r, r)))


class PrecondState(NamedTuple):
    """The (freezable) preconditioner data for the Schur PCG solve.

    Which fields are populated is static per ``precond`` string; the pytree
    is therefore shape-stable and can live in a ``lax.while_loop`` carry —
    that is what lets GaussNewton reuse one preconditioner across GN
    iterations (config.pcg_precond_refresh).
    """

    local: object   # TridiagPrecond ("tridiag") or inv-s_diag [N,d,d]
    coarse: object  # dense Cholesky factor of S_c, or () when no coarse


def _matvec_and_sdiag(d: BlockSystem, hll_inv, graph, axis_name):
    """The S-operator at the current (damped) linearization, plus a thunk
    for the exact diagonal blocks of S (only the preconditioner build needs
    them — the freeze path skips the computation entirely).  Dual-layout
    when the graph carries a plan — including under shard_map, where the
    plan holds per-shard tables (gather_plan.build_sharded_plan) and the
    matvec psums its edge partials."""
    if graph.plan is not None:
        # dual-layout operator: no per-edge gathers inside the PCG loop
        op = make_plan_operator(d, hll_inv, graph)
        return (
            lambda x: plan_matvec(op, x, axis_name),
            lambda: plan_s_diag(op, axis_name),
        )
    return (
        lambda x: schur_matvec(d, hll_inv, graph, x, axis_name),
        lambda: schur_s_diag(d, hll_inv, graph, axis_name),
    )


def build_precond(
    d: BlockSystem,
    hll_inv: jax.Array,
    graph: FactorGraph2D,
    s_diag: jax.Array,
    precond: str,
    coarse_group: int,
    axis_name: str | None = None,
    chunk: int = 64,
) -> PrecondState:
    """Build the PCG preconditioner at the current linearization.

    * "jacobi"  — inverse block diagonal of S (local only);
    * "tridiag" — exact solve of the block-tridiagonal part of S (exact
      diagonal + odometry-chain coupling) via parallel cyclic reduction;
    * "chunk"   — the same block-tridiagonal solve restricted to
      ``chunk``-pose chunks, applied as one batched matmul
      (build_chunk_precond) — the latency-optimal local preconditioner;
    * "<local>+coarse" — two-level: the local preconditioner plus an
      additive Galerkin coarse-grid correction over groups of
      ``coarse_group`` poses (build_coarse_precond) — required for large
      graphs, where smooth error modes otherwise dominate the iteration
      count.
    """
    local_kind, _, coarse_kind = precond.partition("+")
    if local_kind == "tridiag":
        upper = chain_upper(d, graph.odom.i, graph.odom.j,
                            graph.num_poses, axis_name)
        local = build_tridiag_precond(s_diag, upper)
    elif local_kind == "chunk":
        upper = chain_upper(d, graph.odom.i, graph.odom.j,
                            graph.num_poses, axis_name)
        local = build_chunk_precond(s_diag, upper, chunk)
    else:
        local = inv_blocks(s_diag)
    if coarse_kind == "coarse":
        coarse = build_coarse_precond(d, hll_inv, graph, coarse_group,
                                      axis_name)
    else:
        coarse = ()
    return PrecondState(local=local, coarse=coarse)


def precond_apply_fn(pstate: PrecondState, precond: str, coarse_group: int):
    """The ``z = M^-1 r`` closure for a built PrecondState."""
    local_kind, _, coarse_kind = precond.partition("+")
    if local_kind == "tridiag":
        local_apply = lambda r: tridiag_apply(pstate.local, r)  # noqa: E731
    elif local_kind == "chunk":
        local_apply = lambda r: chunk_apply(pstate.local, r)  # noqa: E731
    else:
        local_apply = lambda r: bm.mv(pstate.local, r)  # noqa: E731
    if coarse_kind == "coarse":
        return lambda r: (
            local_apply(r) + coarse_apply(pstate.coarse, coarse_group, r)
        )
    return local_apply


def schur_solve(
    sys: BlockSystem,
    graph: FactorGraph2D,
    lam: jax.Array,
    tol: float,
    max_iters: int,
    axis_name: str | None = None,
    restart_every: int = 64,
    precond: str = "tridiag",
    coarse_group: int = 64,
    pstate: PrecondState | None = None,
    chunk: int = 64,
    unroll: bool = False,
) -> tuple[jax.Array, jax.Array, "SolveStats"]:
    """Solve ``(H + lam I) dx = -b`` via Schur elimination + PCG.

    Returns ``(dx_poses [N,3], dx_landmarks [M,2], stats)``.  Under
    shard_map the PCG state lives replicated on every device; only the
    matvec partials cross the mesh (one [N,3] psum per iteration).  ``precond`` selects the PCG preconditioner (see build_precond);
    passing a prebuilt ``pstate`` skips the build (the freeze path).
    """
    d = damp(sys, lam)
    hll_inv = inv_blocks(d.hll)

    rhs = -d.bp + hpl_matvec(
        d, graph.lm_edges.pose, graph.lm_edges.lm,
        bm.mv(hll_inv, d.bl), graph.num_poses, axis_name,
        graph.plan,
    )
    matvec, s_diag_fn = _matvec_and_sdiag(d, hll_inv, graph, axis_name)
    if pstate is None:
        pstate = build_precond(d, hll_inv, graph, s_diag_fn(), precond,
                               coarse_group, axis_name, chunk)
    precond_apply = precond_apply_fn(pstate, precond, coarse_group)

    res = pcg(
        matvec=matvec,
        precond_apply=precond_apply,
        rhs=rhs,
        tol=tol,
        max_iters=max_iters,
        restart_every=restart_every,
        unroll=unroll,
    )
    dx_p = res.x
    u = hlp_matvec(
        d, graph.lm_edges.pose, graph.lm_edges.lm, dx_p,
        graph.num_landmarks, axis_name, graph.plan,
    )
    dx_l = bm.mv(hll_inv, -d.bl - u)
    stats = SolveStats(pcg_iters=res.iterations,
                       pcg_residual=res.residual_norm)
    return dx_p, dx_l, stats


def schur_linearize_solve(cfg: OptimizerConfig, axis_name: str | None = None):
    """LinearizeSolve implementation plugging into GaussNewton.

    With ``cfg.pcg_precond_refresh != 1`` (single-device only) the returned
    solve is *stateful*: it exposes ``init_state(graph)`` and takes/returns
    a ``(PrecondState, call_count)`` carry, so GaussNewton threads one
    preconditioner through its while_loop instead of refactoring it every
    iteration (build cost ~34 ms/iter on the 10k workload vs a few extra
    PCG iterations).
    """

    def _assemble(graph: FactorGraph2D):
        return assemble_blocks(
            graph,
            huber_delta=cfg.huber_delta,
            fixed_prior=cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians,
            axis_name=axis_name,
        )

    refresh = cfg.pcg_precond_refresh
    if refresh == 1 or axis_name is not None:

        def solve(graph: FactorGraph2D, lam: jax.Array):
            sys = _assemble(graph)
            dx_p, dx_l, stats = schur_solve(
                sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters, axis_name,
                cfg.pcg_restart_every, cfg.pcg_precond,
                cfg.pcg_coarse_group, chunk=cfg.pcg_chunk,
                unroll=cfg.pcg_unroll,
            )
            return dx_p, dx_l, sys.err, stats

        return solve

    def _build(graph: FactorGraph2D, lam: jax.Array):
        sys = _assemble(graph)
        d = damp(sys, lam)
        hll_inv = inv_blocks(d.hll)
        _, s_diag_fn = _matvec_and_sdiag(d, hll_inv, graph, None)
        return build_precond(
            d, hll_inv, graph, s_diag_fn(), cfg.pcg_precond,
            cfg.pcg_coarse_group, chunk=cfg.pcg_chunk,
        )

    def init_state(graph: FactorGraph2D):
        lam0 = jnp.asarray(cfg.lambda_init, graph.poses.dtype)
        return (_build(graph, lam0), jnp.asarray(0, jnp.int32))

    def solve_stateful(graph: FactorGraph2D, lam: jax.Array, state):
        pstate, calls = state
        if refresh > 1:
            # Same-shape branches; single-device only, so no collectives
            # live under the conditional.  calls==0 is excluded: init_state
            # already built at the same graph/lambda, so rebuilding there
            # would duplicate the full linearization.
            pstate = jax.lax.cond(
                ((calls % refresh) == 0) & (calls > 0),
                lambda: _build(graph, lam),
                lambda: pstate,
            )
        sys = _assemble(graph)
        dx_p, dx_l, stats = schur_solve(
            sys, graph, lam, cfg.pcg_tol, cfg.pcg_max_iters, None,
            cfg.pcg_restart_every, cfg.pcg_precond, cfg.pcg_coarse_group,
            pstate=pstate, chunk=cfg.pcg_chunk, unroll=cfg.pcg_unroll,
        )
        return dx_p, dx_l, sys.err, stats, (pstate, calls + 1)

    solve_stateful.stateful = True
    solve_stateful.init_state = init_state
    return solve_stateful

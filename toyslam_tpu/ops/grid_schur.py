"""Grid-order Schur assembly + solve for large chain graphs.

The general Schur path (ops/schur.py) linearizes edges in insertion order
and pays for that freedom three times per Gauss-Newton iteration:

  * per-vertex reductions are gathers over edge-order arrays
    (assemble_blocks),
  * the dual-layout PlanOperator re-materializes every per-edge block into
    vertex-major grids (make_plan_operator),
  * the odometry part of every PCG matvec gathers chain neighbors that are
    literally adjacent rows.

This module removes all three by fixing the EDGE ORDER host-side instead:
the landmark edges are stored twice — once sorted by landmark and padded
to a ``[M, Kl]`` grid, once sorted by pose into ``[N, Kp]`` — and the
odometry chain is stored positionally (row v = edge (v, v+1)).  The same
per-edge linearization formulas (ops/residuals.py) then run on flat views
of the grids, every reduction is a dense ``sum`` over the slot axis, the
vertex-major operator grids fall out of the linearization with no
relayout, and the chain part of the matvec is two lane shifts.  The
linearization runs twice (once per order); its FLOPs are negligible next
to the gathers it replaces.

Scope (gated in GaussNewton wiring): single-device, SE(2), chain-only
odometry (j = i+1 — the 10k workloads and every frontend trajectory;
loop-closure odometry falls back to the general path), XLA PCG loop.
The preconditioner build reuses ops/schur.py's ``build_precond`` through
flat views of the grids (its segment-sums run once per
``pcg_precond_refresh`` — amortized), and its apply is
schur.precond_apply_fn.

Reference context: this replaces the role of the reference's dense-QR
solver at scale (remote/cuda/solver/SolverCudaQr.h:44-81) — the reference
caps at O(N^2) dense memory (python/optimizer/graph_optimizer.py:105).
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.models.graph import FactorGraph2D
from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import edge_blocks
from toyslam_tpu.ops import residuals as res_ops
from toyslam_tpu.ops import schur

_f32 = jnp.float32
_i32 = jnp.int32


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GridPlan:
    """Host-built dual-order edge storage (see module docstring).

    Flat shapes: lm-major arrays are ``[M * Kl]``, pose-major ``[N * Kp]``;
    the grids are reshapes.  ``Kl``/``Kp`` are the max incidence counts
    (shape-derived, static).
    """

    # lm-major copy (slot (m, k) -> k-th observation of landmark m)
    L_pose: jax.Array   # i32[M*Kl] observing pose
    L_lm: jax.Array     # i32[M*Kl] landmark id (m repeated)
    L_meas: jax.Array   # f32[M*Kl, 2]
    L_info: jax.Array   # f32[M*Kl, 2, 2]
    L_mask: jax.Array   # f32[M*Kl]
    # pose-major copy (slot (p, k) -> k-th observation from pose p)
    P_pose: jax.Array   # i32[N*Kp]
    P_lm: jax.Array     # i32[N*Kp]
    P_meas: jax.Array
    P_info: jax.Array
    P_mask: jax.Array
    # odometry chain, positional (row v = edge (v, v+1); last row masked)
    C_meas: jax.Array   # f32[N, 3]
    C_info: jax.Array   # f32[N, 3, 3]
    C_mask: jax.Array   # f32[N]


def build_grid_plan(graph: FactorGraph2D) -> GridPlan:
    """Host-side dual-order construction.  Raises if any real odometry
    edge is non-chain (the caller gates on this)."""
    n, m = graph.num_poses, graph.num_landmarks
    lp = np.asarray(graph.lm_edges.pose)
    ll = np.asarray(graph.lm_edges.lm)
    lmask = np.asarray(graph.lm_edges.mask)
    lmeas = np.asarray(graph.lm_edges.meas)
    linfo = np.asarray(graph.lm_edges.info)
    real = lmask > 0

    def order_copy(key_ids, num):
        ids = key_ids[real]
        sel = np.nonzero(real)[0]
        counts = np.bincount(ids, minlength=num)
        k = max(int(counts.max()) if counts.size else 0, 1)
        slot_pose = np.zeros(num * k, np.int32)
        slot_lm = np.zeros(num * k, np.int32)
        slot_meas = np.zeros((num * k, 2), np.float32)
        slot_info = np.zeros((num * k, 2, 2), np.float32)
        slot_mask = np.zeros(num * k, np.float32)
        order = np.argsort(ids, kind="stable")
        sid = ids[order]
        sedge = sel[order]
        starts = np.searchsorted(sid, np.arange(num))
        slots = np.arange(sid.shape[0]) - starts[sid]
        flat = sid * k + slots
        slot_pose[flat] = lp[sedge]
        slot_lm[flat] = ll[sedge]
        slot_meas[flat] = lmeas[sedge]
        slot_info[flat] = linfo[sedge]
        slot_mask[flat] = 1.0
        return k, slot_pose, slot_lm, slot_meas, slot_info, slot_mask

    _, L_pose, L_lm, L_meas, L_info, L_mask = order_copy(ll, m)
    _, P_pose, P_lm, P_meas, P_info, P_mask = order_copy(lp, n)

    oi = np.asarray(graph.odom.i)
    oj = np.asarray(graph.odom.j)
    omask = np.asarray(graph.odom.mask)
    oreal = omask > 0
    if not np.all(oj[oreal] == oi[oreal] + 1):
        raise ValueError("grid_schur requires chain-only odometry")
    C_meas = np.zeros((n, 3), np.float32)
    C_info = np.zeros((n, 3, 3), np.float32)
    C_mask = np.zeros(n, np.float32)
    rows = oi[oreal]
    if np.unique(rows).size != rows.size:
        # positional storage holds ONE edge per (v, v+1) pair; a duplicate
        # would be silently dropped (last write wins) where the general
        # schur path segment-sums it — fail loudly like the non-chain check
        raise ValueError("grid_schur requires at most one odometry edge "
                         "per (v, v+1) pair")
    C_meas[rows] = np.asarray(graph.odom.meas)[oreal]
    C_info[rows] = np.asarray(graph.odom.info)[oreal]
    C_mask[rows] = 1.0
    return GridPlan(
        L_pose=L_pose, L_lm=L_lm, L_meas=L_meas, L_info=L_info,
        L_mask=L_mask,
        P_pose=P_pose, P_lm=P_lm, P_meas=P_meas, P_info=P_info,
        P_mask=P_mask,
        C_meas=C_meas, C_info=C_info, C_mask=C_mask,
    )


def _shift_up(x, s=1):
    """y[v] = x[v+s], zero fill (leading axis)."""
    return jnp.concatenate([x[s:], jnp.zeros_like(x[:s])], axis=0)


def _shift_down(x, s=1):
    """y[v] = x[v-s], zero fill."""
    return jnp.concatenate([jnp.zeros_like(x[:s]), x[:-s]], axis=0)


class _GridSystem:
    """Per-solve linearized quantities in grid order."""

    __slots__ = (
        "hpp_diag", "tupper", "hll", "bp", "bl", "err",
        "hpl_L", "hpl_P", "kl", "kp",
    )

    def __init__(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)


def _assemble(graph: FactorGraph2D, gp: GridPlan, cfg: OptimizerConfig):
    n, m = graph.num_poses, graph.num_landmarks
    kl = gp.L_pose.shape[0] // m
    kp = gp.P_pose.shape[0] // n

    # landmark edges, both orders, same formulas as the general path
    lb_L = edge_blocks.lm_edge_blocks(
        graph.poses, graph.landmarks, gp.L_pose, gp.L_lm, gp.L_meas,
        gp.L_info, gp.L_mask, cfg.huber_delta,
    )
    lb_P = edge_blocks.lm_edge_blocks(
        graph.poses, graph.landmarks, gp.P_pose, gp.P_lm, gp.P_meas,
        gp.P_info, gp.P_mask, cfg.huber_delta,
    )
    hll = jnp.sum(lb_L.w_btb.reshape(m, kl, 2, 2), axis=1)
    bl = jnp.sum(lb_L.bl_c.reshape(m, kl, 2), axis=1)
    hpl_L = lb_L.w_hpl.reshape(m, kl, 3, 2)
    hpp_lm = jnp.sum(lb_P.w_ata.reshape(n, kp, 3, 3), axis=1)
    bp_lm = jnp.sum(lb_P.bp_c.reshape(n, kp, 3), axis=1)
    hpl_P = lb_P.w_hpl.reshape(n, kp, 3, 2)

    # odometry chain: row v = edge (v, v+1); per-row blocks combine into
    # the diagonal/superdiagonal with shifts, never gathers
    vidx = jnp.arange(n, dtype=_i32)
    jidx = jnp.minimum(vidx + 1, n - 1)
    if cfg.exact_odom_jacobians:
        od = res_ops.eval_odom_edges(
            graph.poses, vidx, jidx, gp.C_meas, gp.C_info, gp.C_mask,
            cfg.huber_delta, exact=True,
        )
        w_od = od.w[:, None, None] * gp.C_info
        ata = bm.quad(od.JA, w_od)
        btb = bm.quad(od.JB, w_od)
        tupper = bm.mtm(od.JA, bm.mm(w_od, od.JB))
        wr = bm.mv(w_od, od.r)
        bp_i = bm.mtv(od.JA, wr)
        bp_j = bm.mtv(od.JB, wr)
        odom_err = jnp.sum(od.robust_err)
    else:
        ob = edge_blocks.odom_edge_blocks(
            graph.poses, vidx, jidx, gp.C_meas, gp.C_info, gp.C_mask,
            cfg.huber_delta,
        )
        ata = ob.w_info
        btb = ob.w_info
        tupper = -ob.w_info
        bp_i = -ob.wr
        bp_j = ob.wr
        odom_err = jnp.sum(ob.robust_err)

    hpp_diag = hpp_lm + ata + _shift_down(btb)
    bp = bp_lm + bp_i + _shift_down(bp_j)

    # gauge priors + padding regularization (identical to assemble_blocks)
    eye3 = jnp.eye(3, dtype=_f32)
    eye2 = jnp.eye(2, dtype=_f32)
    pose_reg = cfg.fixed_prior * graph.pose_fixed + (1.0 - graph.pose_mask)
    lm_reg = cfg.fixed_prior * graph.lm_fixed + (1.0 - graph.lm_mask)
    hpp_diag = hpp_diag + pose_reg[:, None, None] * eye3
    hll = hll + lm_reg[:, None, None] * eye2
    bp = bp * (1.0 - graph.pose_fixed)[:, None]
    bl = bl * (1.0 - graph.lm_fixed)[:, None]
    err = odom_err + jnp.sum(lb_L.robust_err)

    return _GridSystem(
        hpp_diag=hpp_diag, tupper=tupper, hll=hll, bp=bp, bl=bl, err=err,
        hpl_L=hpl_L, hpl_P=hpl_P, kl=kl, kp=kp,
    )


def _flat_system(g: _GridSystem, graph, gp: GridPlan) -> schur.BlockSystem:
    """Flat-view adapter so schur.build_precond runs unchanged on grid
    quantities (its segment-sums are amortized by the refresh)."""
    return schur.BlockSystem(
        hpp_diag=g.hpp_diag,
        hpp_off=g.tupper,
        hll=g.hll,
        hpl=g.hpl_P.reshape(-1, 3, 2),
        bp=g.bp,
        bl=g.bl,
        err=g.err,
    )


class _FlatGraphView:
    """Duck-typed graph view over the pose-major grid for the
    preconditioner build: the positional chain (v, v+1) as odometry."""

    __slots__ = ("num_poses", "num_landmarks", "odom", "lm_edges", "plan")

    class _O:
        __slots__ = ("i", "j")

        def __init__(self, n):
            self.i = jnp.arange(n, dtype=_i32)
            self.j = jnp.minimum(self.i + 1, n - 1)

    class _E:
        __slots__ = ("pose", "lm")

        def __init__(self, pose, lm):
            self.pose = pose
            self.lm = lm

    def __init__(self, graph, gp):
        self.num_poses = graph.num_poses
        self.num_landmarks = graph.num_landmarks
        self.odom = self._O(graph.num_poses)
        self.lm_edges = self._E(gp.P_pose, gp.P_lm)
        self.plan = None


def _damp(g: _GridSystem, lam):
    eye3 = jnp.eye(3, dtype=_f32)
    eye2 = jnp.eye(2, dtype=_f32)
    g2 = _GridSystem(
        hpp_diag=g.hpp_diag + lam * eye3,
        tupper=g.tupper,
        hll=g.hll + lam * eye2,
        bp=g.bp, bl=g.bl, err=g.err,
        hpl_L=g.hpl_L, hpl_P=g.hpl_P, kl=g.kl, kp=g.kp,
    )
    return g2


def _matvec_factory(d: _GridSystem, hll_inv, gp: GridPlan, n, m):
    pose_L = gp.L_pose.reshape(m, d.kl)
    lm_P = gp.P_lm.reshape(n, d.kp)
    tlow = jnp.swapaxes(_shift_down(d.tupper), -1, -2)

    def matvec(x):
        u = jnp.sum(bm.mtv(d.hpl_L, x[pose_L]), axis=1)      # [M, 2]
        v = bm.mv(hll_inv, u)
        w = jnp.sum(bm.mv(d.hpl_P, v[lm_P]), axis=1)         # [N, 3]
        y = bm.mv(d.hpp_diag, x)
        y = y + bm.mv(d.tupper, _shift_up(x))
        y = y + bm.mv(tlow, _shift_down(x))
        return y - w

    def s_diag():
        hi = hll_inv[lm_P]
        contrib = jnp.sum(
            bm.mm(bm.mm(d.hpl_P, hi), jnp.swapaxes(d.hpl_P, -1, -2)),
            axis=1,
        )
        return d.hpp_diag - contrib

    return matvec, s_diag


def _build_precond(cfg, d, hll_inv, s_diag, graph, gp):
    """schur.build_precond through flat views of the grids; the result is
    a pytree, so it can ride the GaussNewton while_loop carry on the
    refresh path."""
    return schur.build_precond(
        _flat_system(d, graph, gp), hll_inv, _FlatGraphView(graph, gp),
        s_diag, cfg.pcg_precond, cfg.pcg_coarse_group, chunk=cfg.pcg_chunk,
    )


def _solve_once(cfg, graph, gp, lam, pre=None):
    n, m = graph.num_poses, graph.num_landmarks
    sys_g = _assemble(graph, gp, cfg)
    d = _damp(sys_g, lam)
    hll_inv = schur.inv_blocks(d.hll)
    matvec, s_diag_fn = _matvec_factory(d, hll_inv, gp, n, m)

    pose_L = gp.L_pose.reshape(m, d.kl)
    lm_P = gp.P_lm.reshape(n, d.kp)
    v0 = bm.mv(hll_inv, d.bl)
    rhs = -d.bp + jnp.sum(bm.mv(d.hpl_P, v0[lm_P]), axis=1)

    if pre is None:
        pre = _build_precond(cfg, d, hll_inv, s_diag_fn(), graph, gp)
    res = schur.pcg(
        matvec=matvec,
        precond_apply=schur.precond_apply_fn(
            pre, cfg.pcg_precond, cfg.pcg_coarse_group
        ),
        rhs=rhs,
        tol=cfg.pcg_tol,
        max_iters=cfg.pcg_max_iters,
        restart_every=cfg.pcg_restart_every,
        unroll=cfg.pcg_unroll,
    )
    dx_p = res.x
    u = jnp.sum(bm.mtv(d.hpl_L, dx_p[pose_L]), axis=1)
    dx_l = bm.mv(hll_inv, -d.bl - u)
    stats = schur.SolveStats(pcg_iters=res.iterations,
                             pcg_residual=res.residual_norm)
    return dx_p, dx_l, sys_g.err, stats


def grid_linearize_solve(cfg: OptimizerConfig):
    """LinearizeSolve over grid-order storage; plugs into GaussNewton via
    ``GaussNewton(cfg, solve=grid_linearize_solve(cfg))`` (prepare builds
    the GridPlan host-side) or through config.solver == "schur_grid".

    Honors ``cfg.pcg_precond_refresh`` like the general path: K != 1
    returns a stateful solve that rebuilds the preconditioner every K-th
    iteration (0 = frozen after the initial build).
    """
    refresh = cfg.pcg_precond_refresh

    def _prepare(graph: FactorGraph2D) -> FactorGraph2D:
        if isinstance(graph.plan, GridPlan):
            return graph
        return dataclasses.replace(graph, plan=build_grid_plan(graph))

    if refresh == 1:

        def solve(graph: FactorGraph2D, lam):
            return _solve_once(cfg, graph, graph.plan, lam)

        solve.prepare = _prepare
        return solve

    def _build(graph, lam):
        gp = graph.plan
        sys_g = _assemble(graph, gp, cfg)
        d = _damp(sys_g, lam)
        hll_inv = schur.inv_blocks(d.hll)
        _, s_diag_fn = _matvec_factory(
            d, hll_inv, gp, graph.num_poses, graph.num_landmarks
        )
        return _build_precond(cfg, d, hll_inv, s_diag_fn(), graph, gp)

    def init_state(graph):
        lam0 = jnp.asarray(cfg.lambda_init, graph.poses.dtype)
        return (_build(graph, lam0), jnp.asarray(0, _i32))

    def solve_stateful(graph: FactorGraph2D, lam, state):
        pre, calls = state
        if refresh > 1:
            pre = jax.lax.cond(
                ((calls % refresh) == 0) & (calls > 0),
                lambda: _build(graph, lam),
                lambda: pre,
            )
        dx_p, dx_l, err, stats = _solve_once(
            cfg, graph, graph.plan, lam, pre=pre
        )
        return dx_p, dx_l, err, stats, (pre, calls + 1)

    solve_stateful.stateful = True
    solve_stateful.init_state = init_state
    solve_stateful.prepare = _prepare
    return solve_stateful

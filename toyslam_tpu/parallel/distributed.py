"""Distributed bundle adjustment: shard_map over edges + psum reductions.

Layout: pose and landmark *states* are replicated (they are tiny next to the
edge set); odometry and landmark *edges* are sharded along the mesh's edge
axis.  Each device linearizes its edge shard, the per-vertex reductions
(diagonal blocks, gradients, chi^2) psum across the mesh once per
linearization, and PCG runs replicated with one ``[N,3]`` psum per matvec —
exactly the collective-Schur-reduction design BASELINE.json's north star
asks for, in place of the reference's socket-based remote optimizer
(python/remote/graph_client.py:16-52 ↔ remote/app/ConnectionHandler.h:14-37).

Everything funnels through the same ``ops/schur.py`` code with
``axis_name`` set — the distributed path *is* the single-chip path plus
collectives, so correctness tests can diff the two directly.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import jax
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.models.graph import FactorGraph2D, LandmarkEdges, OdomEdges
from toyslam_tpu.ops import schur
from toyslam_tpu.ops.schur import SolveStats
from toyslam_tpu.parallel.mesh import EDGE_AXIS, pad_edges_for_mesh

# the LinearizeSolve output spec: (dx_p, dx_l, err, stats) all replicated
_OUT_SPECS = (P(), P(), P(), SolveStats(pcg_iters=P(), pcg_residual=P()))


def graph_shard_specs(axis: str = EDGE_AXIS) -> FactorGraph2D:
    """PartitionSpec pytree for a FactorGraph2D: edges sharded, states
    replicated."""
    e = P(axis)
    r = P()
    return FactorGraph2D(
        poses=r,
        landmarks=r,
        pose_mask=r,
        lm_mask=r,
        pose_fixed=r,
        lm_fixed=r,
        odom=OdomEdges(i=e, j=e, meas=e, info=e, mask=e),
        lm_edges=LandmarkEdges(pose=e, lm=e, meas=e, info=e, mask=e),
    )


def graph3d_shard_specs(axis: str = EDGE_AXIS):
    """PartitionSpec pytree for a FactorGraph3D (same layout policy: edges
    sharded along the mesh, pose/landmark states + intrinsics replicated)."""
    from toyslam_tpu.models.graph3d import (
        FactorGraph3D, Odom3DEdges, ReprojEdges,
    )

    e = P(axis)
    r = P()
    return FactorGraph3D(
        poses=r,
        landmarks=r,
        pose_mask=r,
        lm_mask=r,
        pose_fixed=r,
        lm_fixed=r,
        odom=Odom3DEdges(i=e, j=e, meas=e, info=e, mask=e),
        lm_edges=ReprojEdges(pose=e, lm=e, meas=e, info=e, mask=e),
        intrinsics=r,
    )


def _plan_specs(axis: str):
    """PartitionSpec pytree for a *sharded* GatherPlan (leading device
    axis on every table, gather_plan.build_sharded_plan)."""
    from toyslam_tpu.ops.gather_plan import GatherPlan, VertexTable

    t = VertexTable(idx=P(axis), mask=P(axis))
    return GatherPlan(lm_by_pose=t, lm_by_lm=t, odom_by_i=t, odom_by_j=t)


def _is_sharded_plan(plan) -> bool:
    return plan is not None and plan.lm_by_pose.idx.ndim == 3


def distributed_linearize_solve(
    cfg: OptimizerConfig, mesh: Mesh, axis: str = EDGE_AXIS
):
    """A LinearizeSolve that runs the Schur/PCG solve across ``mesh``.

    Plugs into ``GaussNewton(config, solve=...)`` unchanged — the outer
    damping/convergence loop is oblivious to the distribution.

    Exposes ``prepare(graph)`` (called by GaussNewton._prepare, host-side,
    once per graph structure): pads the edge arrays to the mesh and
    attaches *per-shard* gather tables (gather_plan.build_sharded_plan),
    so the scatter-free reductions and the dual-layout PlanOperator serve
    the distributed PCG loop exactly as they do single-device.
    """
    inner = schur.schur_linearize_solve(cfg, axis_name=axis)
    n_dev = mesh.shape[axis]
    check_vma = True

    sharded_noplan = shard_map(
        inner,
        mesh=mesh,
        in_specs=(graph_shard_specs(axis), P()),
        out_specs=_OUT_SPECS,
        check_vma=check_vma,
    )

    def inner_local_plan(graph: FactorGraph2D, lam: jax.Array):
        # each device's block sees its own [1, V, K] table shard
        plan = jax.tree.map(lambda a: a[0], graph.plan)
        return inner(dataclasses.replace(graph, plan=plan), lam)

    specs_plan = dataclasses.replace(
        graph_shard_specs(axis), plan=_plan_specs(axis)
    )
    sharded_plan = shard_map(
        inner_local_plan,
        mesh=mesh,
        in_specs=(specs_plan, P()),
        out_specs=_OUT_SPECS,
        check_vma=check_vma,
    )

    def prepare(graph: FactorGraph2D) -> FactorGraph2D:
        from toyslam_tpu.ops.gather_plan import build_sharded_plan

        if _is_sharded_plan(graph.plan):
            return graph
        graph = dataclasses.replace(graph, plan=None)
        if not getattr(graph.lm_edges.pose, "is_fully_addressable", True):
            # global multi-process arrays can't be fetched to the host to
            # build tables (shard_graph attaches the plan pre-placement);
            # run the segment-sum path — solve() pads lazily
            return graph
        graph = pad_edges_for_mesh(graph, n_dev)
        return dataclasses.replace(
            graph, plan=build_sharded_plan(graph, n_dev)
        )

    def solve(graph: FactorGraph2D, lam: jax.Array):
        if _is_sharded_plan(graph.plan):
            return sharded_plan(graph, lam)
        if graph.plan is not None:
            # single-device tables index the global edge arrays — unusable
            # under shard_map; fall back to segment_sum
            graph = dataclasses.replace(graph, plan=None)
        graph = pad_edges_for_mesh(graph, n_dev)
        return sharded_noplan(graph, lam)

    solve.prepare = prepare
    return solve


def distributed_linearize_solve_3d(
    cfg: OptimizerConfig, mesh: Mesh, axis: str = EDGE_AXIS
):
    """Distributed SE(3) BA: same edge-sharded collective-Schur design as
    the 2D path, over the 6/3 block system (ops/schur3d.py).  Plugs into
    ``GaussNewton(config, solve=..., retract=se3.retract)``."""
    from toyslam_tpu.ops.schur3d import schur3d_linearize_solve

    inner = schur3d_linearize_solve(cfg, axis_name=axis)
    specs = graph3d_shard_specs(axis)

    sharded = shard_map(
        inner,
        mesh=mesh,
        in_specs=(specs, P()),
        out_specs=_OUT_SPECS,
        check_vma=True,
    )

    n_dev = mesh.shape[axis]

    def solve(graph, lam: jax.Array):
        if graph.plan is not None:
            graph = dataclasses.replace(graph, plan=None)
        graph = pad_edges_for_mesh(graph, n_dev)
        return sharded(graph, lam)

    return solve

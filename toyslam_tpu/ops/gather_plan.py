"""Scatter-free reductions: per-vertex edge tables turn segment_sum into
gather + dense reduce.

A ``segment_sum`` is a scatter-add: on a GPU it runs with atomics, whose
sum order changes from run to run.  The alternative is the transpose of
the classic CSR trick: precompute, per vertex, the (padded, fixed-capacity)
list of incident edge indices, then every per-vertex reduction becomes

    out[v] = sum_k values[ table[v, k] ] * mask[v, k]

— a gather, an elementwise multiply, and a dense axis reduction.  No
atomics (CUDA reference: KernelSe2.cu:83-110), no mutex (OptimizerCpu.h:
101-118), no scatter: deterministic and elementwise.

The tables depend only on graph *structure* (host-side index arrays), so
they are built once per graph on the host and reused across all GN/PCG
iterations.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from toyslam_tpu.models.graph import FactorGraph2D


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class VertexTable:
    """Edges incident to each of V vertices, padded to capacity K."""

    idx: jax.Array    # i32[V, K] edge index (0 where padded)
    mask: jax.Array   # f32[V, K] 1.0 = real entry


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class GatherPlan:
    lm_by_pose: VertexTable   # landmark edges grouped by observing pose
    lm_by_lm: VertexTable     # landmark edges grouped by landmark
    odom_by_i: VertexTable    # odometry edges grouped by first pose
    odom_by_j: VertexTable    # odometry edges grouped by second pose


def _build_table(
    vertex_ids: np.ndarray, mask: np.ndarray, num_vertices: int,
    k_override: int | None = None,
) -> VertexTable:
    ids = vertex_ids[mask > 0]
    edge_idx = np.nonzero(mask > 0)[0]
    counts = np.bincount(ids, minlength=num_vertices)
    # capacity = the actual max incident count: gather cost scales with
    # ROWS gathered, so padding K up multiplies the dominant PCG matvec cost
    k = max(int(counts.max()) if counts.size else 0, 1)
    if k_override is not None:
        assert k_override >= k, (k_override, k)
        k = k_override
    tbl = np.zeros((num_vertices, k), np.int32)
    msk = np.zeros((num_vertices, k), np.float32)
    # vectorized slot assignment: edges sorted by vertex id keep their
    # relative order; slot = rank within the vertex's run
    order = np.argsort(ids, kind="stable")
    sorted_ids = ids[order]
    sorted_edges = edge_idx[order]
    starts = np.searchsorted(sorted_ids, np.arange(num_vertices))
    slots = np.arange(sorted_ids.shape[0]) - starts[sorted_ids]
    tbl[sorted_ids, slots] = sorted_edges
    msk[sorted_ids, slots] = 1.0
    return VertexTable(idx=tbl, mask=msk)


def build_gather_plan(graph: FactorGraph2D) -> GatherPlan:
    """Host-side construction from the graph's (host-resident) index
    arrays."""
    n, m = graph.num_poses, graph.num_landmarks
    lm_mask = np.asarray(graph.lm_edges.mask)
    od_mask = np.asarray(graph.odom.mask)
    return GatherPlan(
        lm_by_pose=_build_table(np.asarray(graph.lm_edges.pose), lm_mask, n),
        lm_by_lm=_build_table(np.asarray(graph.lm_edges.lm), lm_mask, m),
        odom_by_i=_build_table(np.asarray(graph.odom.i), od_mask, n),
        odom_by_j=_build_table(np.asarray(graph.odom.j), od_mask, n),
    )


def attach_plan(graph: FactorGraph2D) -> FactorGraph2D:
    """Graph with gather tables attached (host-side, once per structure)."""
    return dataclasses.replace(graph, plan=build_gather_plan(graph))


def _build_sharded_table(
    vertex_ids: np.ndarray, mask: np.ndarray, num_vertices: int, n_dev: int
) -> VertexTable:
    """Per-shard tables, stacked on a leading device axis ``[D, V, K]``.

    Edges are sharded into ``n_dev`` contiguous chunks (jax shards axis 0
    of a ``P(axis)``-annotated array exactly so); shard ``d``'s table lists
    the *local* indices of its chunk's edges per vertex.  ``K`` is the max
    incident count over all shards so the stacked pytree is rectangular.
    """
    e = vertex_ids.shape[0]
    assert e % n_dev == 0, (e, n_dev)
    chunk = e // n_dev
    ks = []
    for d in range(n_dev):
        sl = slice(d * chunk, (d + 1) * chunk)
        ids = vertex_ids[sl][mask[sl] > 0]
        counts = np.bincount(ids, minlength=num_vertices)
        ks.append(int(counts.max()) if counts.size else 0)
    k = max(max(ks), 1)
    tables = [
        _build_table(
            vertex_ids[d * chunk : (d + 1) * chunk],
            mask[d * chunk : (d + 1) * chunk],
            num_vertices,
            k_override=k,
        )
        for d in range(n_dev)
    ]
    return VertexTable(
        idx=np.stack([np.asarray(t.idx) for t in tables]),
        mask=np.stack([np.asarray(t.mask) for t in tables]),
    )


def build_sharded_plan(graph: FactorGraph2D, n_dev: int) -> GatherPlan:
    """Gather plan for an edge-sharded graph: tables carry a leading device
    axis ``[D, V, K]`` sharded with the edges, so each device's shard_map
    block sees its own local tables (squeeze the leading axis inside).

    This is what lets the scatter-free reductions AND the dual-layout
    PlanOperator serve the distributed path (round-1 fell back to
    segment_sum under shard_map)."""
    n, m = graph.num_poses, graph.num_landmarks
    return GatherPlan(
        lm_by_pose=_build_sharded_table(
            np.asarray(graph.lm_edges.pose), np.asarray(graph.lm_edges.mask),
            n, n_dev,
        ),
        lm_by_lm=_build_sharded_table(
            np.asarray(graph.lm_edges.lm), np.asarray(graph.lm_edges.mask),
            m, n_dev,
        ),
        odom_by_i=_build_sharded_table(
            np.asarray(graph.odom.i), np.asarray(graph.odom.mask), n, n_dev,
        ),
        odom_by_j=_build_sharded_table(
            np.asarray(graph.odom.j), np.asarray(graph.odom.mask), n, n_dev,
        ),
    )


def table_sum(values: jax.Array, table: VertexTable) -> jax.Array:
    """``out[v] = sum over incident edges of values[e]`` — scatter-free.

    ``values``: f32[E, ...] per-edge quantities; returns f32[V, ...].
    """
    gathered = values[table.idx]                       # [V, K, ...]
    mask = table.mask.reshape(
        table.mask.shape + (1,) * (gathered.ndim - 2)
    )
    return jnp.sum(gathered * mask, axis=1)

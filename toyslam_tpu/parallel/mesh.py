"""Device meshes (single- and multi-host) and graph sharding/padding.

The reference's only distribution mechanism is a TCP client/server pair
moving one whole graph per request (reference
python/remote/graph_client.py:13-52 ↔ remote/conn/ConnectionManagerServer.h:
22-61).  The replacement is a jax device mesh: edges shard along one
axis, and reductions run as the XLA collectives inserted for ``psum``
(NCCL over NVLink between the GPUs of a host) — no sockets in the hot
path.  Every GPU of a host reaches every other at the same rate, so the
mesh is flat and follows the algorithm alone.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from toyslam_tpu.models.graph import FactorGraph2D

EDGE_AXIS = "edges"


def initialize_distributed(
    coordinator: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
) -> bool:
    """Join (or skip) the multi-process JAX runtime.

    Values default from the environment (``TOYSLAM_COORDINATOR``,
    ``TOYSLAM_NUM_PROCESSES``, ``TOYSLAM_PROCESS_ID``), so a launcher can
    configure workers without code changes; with no coordinator configured
    this is a no-op (single-process mode) and returns False.  Verified with
    the Gloo CPU backend (scripts/launch_multihost.py).
    """
    coordinator = coordinator or os.environ.get("TOYSLAM_COORDINATOR")
    if not coordinator:
        return False
    if num_processes is None:
        num_processes = int(os.environ.get("TOYSLAM_NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("TOYSLAM_PROCESS_ID", "0"))
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )
    return True


def make_mesh(num_devices: int | None = None, axis: str = EDGE_AXIS) -> Mesh:
    """A 1D mesh over the first ``num_devices`` devices.

    Single-axis edge/landmark parallelism is the right first shape for BA:
    the pose state is small and replicated; the per-edge work dominates.
    """
    devices = jax.devices()
    if num_devices is not None:
        devices = devices[:num_devices]
    return Mesh(np.asarray(devices), (axis,))


def make_host_mesh(axis: str = EDGE_AXIS) -> Mesh:
    """A 1D mesh over ALL global devices (every process's chips).

    ``jax.devices()`` orders devices process-major, so consecutive shards
    are host-local: per-vertex psums reduce within each host first and
    cross hosts once — the hierarchy XLA's collective lowering exploits
    automatically for a contiguous 1D mesh.
    """
    return Mesh(np.asarray(jax.devices()), (axis,))


def shard_graph(
    graph: FactorGraph2D, mesh: Mesh, axis: str = EDGE_AXIS
) -> FactorGraph2D:
    """Place a (host-resident) graph onto the mesh as global arrays: edge
    arrays sharded along ``axis``, states/masks replicated.

    Works single- and multi-process: every process must hold the identical
    host graph (deterministic construction — same seed, same build), and
    each device receives exactly its shard.  Edge arrays are padded to a
    multiple of the mesh size first so they shard evenly.

    The per-shard gather plan (gather_plan.build_sharded_plan) is built
    HERE, while the edge arrays are still process-local — once the graph
    is global, no process can fetch the full index arrays to the host to
    build tables (jax raises on non-addressable fetch), which is exactly
    the multi-host case.
    """
    from toyslam_tpu.ops.gather_plan import build_sharded_plan

    n_dev = mesh.shape[axis]
    graph = pad_edges_for_mesh(
        dataclasses.replace(graph, plan=None), n_dev
    )
    plan = build_sharded_plan(graph, n_dev)
    edge = NamedSharding(mesh, P(axis))
    repl = NamedSharding(mesh, P())

    def put(x, sharding):
        x = np.asarray(x)
        return jax.make_array_from_callback(
            x.shape, sharding, lambda idx: x[idx]
        )

    od = dataclasses.replace(
        graph.odom,
        i=put(graph.odom.i, edge),
        j=put(graph.odom.j, edge),
        meas=put(graph.odom.meas, edge),
        info=put(graph.odom.info, edge),
        mask=put(graph.odom.mask, edge),
    )
    lm = dataclasses.replace(
        graph.lm_edges,
        pose=put(graph.lm_edges.pose, edge),
        lm=put(graph.lm_edges.lm, edge),
        meas=put(graph.lm_edges.meas, edge),
        info=put(graph.lm_edges.info, edge),
        mask=put(graph.lm_edges.mask, edge),
    )
    return dataclasses.replace(
        graph,
        poses=put(graph.poses, repl),
        landmarks=put(graph.landmarks, repl),
        pose_mask=put(graph.pose_mask, repl),
        lm_mask=put(graph.lm_mask, repl),
        pose_fixed=put(graph.pose_fixed, repl),
        lm_fixed=put(graph.lm_fixed, repl),
        odom=od,
        lm_edges=lm,
        plan=jax.tree.map(lambda a: put(a, edge), plan),
    )


def _pad_axis0(x: jax.Array, target: int) -> jax.Array:
    pad = target - x.shape[0]
    if pad == 0:
        return x
    widths = [(0, pad)] + [(0, 0)] * (x.ndim - 1)
    return jnp.pad(x, widths)


def pad_edges_for_mesh(graph: FactorGraph2D, num_devices: int) -> FactorGraph2D:
    """Pad edge arrays (mask-extended with zeros) to a multiple of the mesh
    size so they shard evenly.  Padded edges have mask 0 and index 0 —
    mathematically inert everywhere (see ops/residuals.py)."""

    def round_up(n):
        return -(-n // num_devices) * num_devices

    od, lm = graph.odom, graph.lm_edges
    e1, e2 = round_up(od.count), round_up(lm.count)
    od = dataclasses.replace(
        od,
        i=_pad_axis0(od.i, e1),
        j=_pad_axis0(od.j, e1),
        meas=_pad_axis0(od.meas, e1),
        info=_pad_axis0(od.info, e1),
        mask=_pad_axis0(od.mask, e1),
    )
    lm = dataclasses.replace(
        lm,
        pose=_pad_axis0(lm.pose, e2),
        lm=_pad_axis0(lm.lm, e2),
        meas=_pad_axis0(lm.meas, e2),
        info=_pad_axis0(lm.info, e2),
        mask=_pad_axis0(lm.mask, e2),
    )
    return dataclasses.replace(graph, odom=od, lm_edges=lm)

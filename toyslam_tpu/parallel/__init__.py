"""Multi-device distribution: device meshes, sharded bundle adjustment.

Replaces the reference's process-level parallelism — the Python client /
C++ TCP optimizer server split (reference python/remote/graph_client.py,
remote/conn/, remote/app/) and the CUDA one-thread-per-edge kernels with
atomicAdd scatter (remote/cuda/optimizer/kernels/) — with a ``shard_map``
over a ``jax.sharding.Mesh``: edges and landmark blocks are sharded across
devices, every reduction is a deterministic XLA collective.
"""

from toyslam_tpu.parallel.mesh import (
    initialize_distributed,
    make_host_mesh,
    make_mesh,
    pad_edges_for_mesh,
    shard_graph,
)
from toyslam_tpu.parallel.distributed import (
    distributed_linearize_solve,
    distributed_linearize_solve_3d,
    graph_shard_specs,
    graph3d_shard_specs,
)
from toyslam_tpu.parallel.partition import (
    PartitionMeta,
    PartitionPlan,
    build_partition,
    partitioned_linearize_solve,
)

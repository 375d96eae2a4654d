"""toyslam_tpu — a 2D/3D SLAM back end built on JAX/XLA.

A from-scratch re-design of the capability surface of the reference 2D LiDAR
SLAM system (fatlipp/ToySlam): simulated LiDAR scan generation, landmark
association, and batch Gauss-Newton factor-graph optimization over SE(2)
odometry and landmark edges with Huber robustification — expressed array-first:

* the factor graph is structs-of-arrays (``models.graph``), not an object graph;
* per-edge residuals/Jacobians are vmapped analytic kernels (``ops.residuals``);
* the normal equations are assembled as one matmul (dense path) or
  block-sparse with Schur-complement landmark elimination + PCG (``ops``);
* scaling is a ``shard_map`` over a device mesh with ``psum`` collectives
  (``parallel``), replacing the reference's TCP client/server split.

Reference parity targets are documented per-module with file:line citations
into the reference tree.
"""

from toyslam_tpu.config import (
    SlamConfig,
    SimConfig,
    LidarConfig,
    NoiseConfig,
    OptimizerConfig,
)
from toyslam_tpu.models.graph import (
    FactorGraph2D,
    OdomEdges,
    LandmarkEdges,
    GraphBuilder2D,
)
from toyslam_tpu.models.graph3d import (
    FactorGraph3D,
    Odom3DEdges,
    ReprojEdges,
    GraphBuilder3D,
)

__version__ = "0.1.0"

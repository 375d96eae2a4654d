"""Structs-of-arrays factor graph for 2D pose-landmark SLAM.

The reference models the optimization graph as an object graph — dicts of
vertex objects with virtual ``update``/``calc_error`` methods and a list of
edge objects (reference python/optimizer/opt_graph.py:1-32, vertices.py:5-46,
edges2d.py:4-78; C++ equivalent remote/graph/GraphCpu.h:12-60).  That shape is
hostile to XLA: dynamic dicts, per-edge virtual dispatch, growing sizes.

Here the graph is a pytree of fixed-shape arrays:

* ``poses``      — ``f32[N, 3]``  (x, y, theta)
* ``landmarks``  — ``f32[M, 2]``
* typed edge sets (``OdomEdges``, ``LandmarkEdges``) holding index arrays and
  stacked measurement/information blocks — the array analogue of the
  reference's per-type edge buckets (GraphCpu.h:56-58);
* validity masks for padding (XLA static shapes) and fixed-vertex masks
  replacing the reference's ``fixed_vertices`` set (opt_graph.py:5,14-16).

A host-side :class:`GraphBuilder2D` accumulates a growing graph with plain
Python/numpy (the frontend is not the hot path) and pads to bucketed shapes so
that XLA recompiles rarely as the trajectory grows.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

_f32 = jnp.float32
_i32 = jnp.int32


def _bucket(n: int, bucket: int) -> int:
    """Round ``n`` up to the next multiple of ``bucket`` (at least one)."""
    return max(bucket, -(-n // bucket) * bucket)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class OdomEdges:
    """SE(2) odometry constraints between consecutive poses.

    Array analogue of the reference's EdgeOdometry2d list
    (python/optimizer/edges2d.py:58-80).  ``info`` keeps the full 3x3 block
    (the reference constructs a diagonal one, slam_main.py:46-51).
    """

    i: jax.Array       # i32[E]   first pose index
    j: jax.Array       # i32[E]   second pose index
    meas: jax.Array    # f32[E,3] measured relative motion (x, y, theta)
    info: jax.Array    # f32[E,3,3] information matrix
    mask: jax.Array    # f32[E]   1.0 = real edge, 0.0 = padding

    @property
    def count(self) -> int:
        return self.i.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LandmarkEdges:
    """Range-bearing landmark observations (EdgeLandmark2d, edges2d.py:14-56)."""

    pose: jax.Array    # i32[E]   observing pose index
    lm: jax.Array      # i32[E]   landmark index (into ``landmarks``)
    meas: jax.Array    # f32[E,2] (range, bearing) in the pose frame
    info: jax.Array    # f32[E,2,2] information matrix
    mask: jax.Array    # f32[E]

    @property
    def count(self) -> int:
        return self.pose.shape[0]


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FactorGraph2D:
    """The whole optimization problem as one pytree of arrays."""

    poses: jax.Array        # f32[N,3]
    landmarks: jax.Array    # f32[M,2]
    pose_mask: jax.Array    # f32[N] 1 = real
    lm_mask: jax.Array      # f32[M]
    pose_fixed: jax.Array   # f32[N] 1 = gauge-fixed (1e6 prior)
    lm_fixed: jax.Array     # f32[M]
    odom: OdomEdges
    lm_edges: LandmarkEdges
    # Optional ops.gather_plan.GatherPlan: per-vertex incident-edge tables
    # that let the solver replace every scatter/segment_sum with gather +
    # dense reduce (no atomics, a fixed sum order).  Attached via
    # ops.gather_plan.attach_plan; None under shard_map (tables index the
    # global edge arrays, which are sharded there).
    plan: object = None

    @property
    def num_poses(self) -> int:
        return self.poses.shape[0]

    @property
    def num_landmarks(self) -> int:
        return self.landmarks.shape[0]

    @property
    def state_dim(self) -> int:
        """Dimension of the stacked state [poses*3 | landmarks*2].

        Matches the reference's vertex offset map ordering when poses come
        first (graph_optimizer.py:95-103 assigns offsets in insertion order;
        slam_main.py:157-187 inserts all poses before all landmarks).
        """
        return 3 * self.num_poses + 2 * self.num_landmarks

    def with_state(
        self, poses: jax.Array, landmarks: jax.Array
    ) -> "FactorGraph2D":
        return dataclasses.replace(self, poses=poses, landmarks=landmarks)


class GraphBuilder2D:
    """Host-side incremental graph construction with bucketed padding.

    Plays the role of the reference's frontend-to-optimizer conversion
    (``construct_optimizer_graph``, slam_main.py:157-187): poses are appended
    in trajectory order, landmarks are assigned dense indices in first-seen
    order, odometry edges connect consecutive poses, and landmark edges store
    the noisy (range, bearing) measurement taken at the observing pose.
    """

    def __init__(
        self,
        pose_bucket: int = 64,
        landmark_bucket: int = 64,
        edge_bucket: int = 256,
        dtype=np.float32,
    ):
        self.pose_bucket = pose_bucket
        self.landmark_bucket = landmark_bucket
        self.edge_bucket = edge_bucket
        self.dtype = dtype
        self._poses: list[np.ndarray] = []
        self._pose_fixed: list[bool] = []
        self._landmarks: list[np.ndarray] = []
        self._lm_fixed: list[bool] = []
        self._lm_index: dict[int, int] = {}  # external id -> dense index
        self._odom: list[tuple[int, int, np.ndarray, np.ndarray]] = []
        self._lm_obs: list[tuple[int, int, np.ndarray, np.ndarray]] = []

    # -- vertices ---------------------------------------------------------

    def add_pose(self, pose_xyt, fixed: bool = False) -> int:
        self._poses.append(np.asarray(pose_xyt, dtype=self.dtype))
        self._pose_fixed.append(bool(fixed))
        return len(self._poses) - 1

    def add_landmark(
        self, external_id: int, position_xy, fixed: bool = False
    ) -> int:
        """First-seen global estimate wins, like Graph2d.add_landmark
        (reference python/slam/graph2d.py:30-32)."""
        if external_id in self._lm_index:
            return self._lm_index[external_id]
        idx = len(self._landmarks)
        self._lm_index[external_id] = idx
        self._landmarks.append(np.asarray(position_xy, dtype=self.dtype))
        self._lm_fixed.append(bool(fixed))
        return idx

    def landmark_index(self, external_id: int) -> int:
        return self._lm_index[external_id]

    @property
    def landmark_id_map(self) -> dict[int, int]:
        return dict(self._lm_index)

    # -- edges ------------------------------------------------------------

    def add_odom_edge(self, i: int, j: int, meas_xyt, info3) -> None:
        self._odom.append(
            (
                i,
                j,
                np.asarray(meas_xyt, dtype=self.dtype),
                np.asarray(info3, dtype=self.dtype),
            )
        )

    def add_landmark_edge(
        self, pose: int, external_lm_id: int, meas_rb, info2
    ) -> None:
        lm = self._lm_index[external_lm_id]
        self._lm_obs.append(
            (
                pose,
                lm,
                np.asarray(meas_rb, dtype=self.dtype),
                np.asarray(info2, dtype=self.dtype),
            )
        )

    # -- state write-back -------------------------------------------------

    def set_state(self, poses: np.ndarray, landmarks: np.ndarray) -> None:
        """Overwrite the builder's pose/landmark estimates with optimized
        values (the reference's ``update_graph``, slam_main.py:196-213).
        ``poses [num_poses, 3]`` / ``landmarks [num_landmarks, 2]`` must
        cover exactly the real (unpadded) vertices."""
        poses = np.asarray(poses, self.dtype)
        landmarks = np.asarray(landmarks, self.dtype)
        if poses.shape != (self.num_poses, 3):
            raise ValueError(
                f"poses {poses.shape} != ({self.num_poses}, 3)"
            )
        if landmarks.shape != (self.num_landmarks, 2):
            raise ValueError(
                f"landmarks {landmarks.shape} != ({self.num_landmarks}, 2)"
            )
        self._poses = [p for p in poses]
        self._landmarks = [l for l in landmarks]

    # -- build ------------------------------------------------------------

    @property
    def num_poses(self) -> int:
        return len(self._poses)

    @property
    def num_landmarks(self) -> int:
        return len(self._landmarks)

    def build(self) -> FactorGraph2D:
        n = len(self._poses)
        m = len(self._landmarks)
        np_, mp = _bucket(n, self.pose_bucket), _bucket(m, self.landmark_bucket)

        poses = np.zeros((np_, 3), self.dtype)
        if n:
            poses[:n] = np.stack(self._poses)
        landmarks = np.zeros((mp, 2), self.dtype)
        if m:
            landmarks[:m] = np.stack(self._landmarks)

        pose_mask = np.zeros(np_, self.dtype)
        pose_mask[:n] = 1.0
        lm_mask = np.zeros(mp, self.dtype)
        lm_mask[:m] = 1.0
        pose_fixed = np.zeros(np_, self.dtype)
        pose_fixed[:n] = np.asarray(self._pose_fixed, self.dtype)
        lm_fixed = np.zeros(mp, self.dtype)
        lm_fixed[:m] = np.asarray(self._lm_fixed, self.dtype)

        odom = self._build_edges(self._odom, 3, self.edge_bucket)
        lmed = self._build_edges(self._lm_obs, 2, self.edge_bucket)

        # Arrays stay host-resident numpy: jit uploads them at dispatch, and
        # host-side consumers (gather-plan build, codecs, viewers) read them
        # without device pulls.
        return FactorGraph2D(
            poses=poses,
            landmarks=landmarks,
            pose_mask=pose_mask,
            lm_mask=lm_mask,
            pose_fixed=pose_fixed,
            lm_fixed=lm_fixed,
            odom=OdomEdges(
                i=odom[0], j=odom[1], meas=odom[2], info=odom[3], mask=odom[4]
            ),
            lm_edges=LandmarkEdges(
                pose=lmed[0], lm=lmed[1], meas=lmed[2], info=lmed[3],
                mask=lmed[4],
            ),
        )

    def _build_edges(self, edges, dim: int, bucket: int):
        e = len(edges)
        ep = _bucket(e, bucket)
        i = np.zeros(ep, np.int32)
        j = np.zeros(ep, np.int32)
        meas = np.zeros((ep, dim), self.dtype)
        info = np.zeros((ep, dim, dim), self.dtype)
        mask = np.zeros(ep, self.dtype)
        if e:
            i[:e] = np.fromiter((x[0] for x in edges), np.int32, e)
            j[:e] = np.fromiter((x[1] for x in edges), np.int32, e)
            meas[:e] = np.stack([x[2] for x in edges])
            info[:e] = np.stack([x[3] for x in edges])
            mask[:e] = 1.0
        return (i, j, meas, info, mask)

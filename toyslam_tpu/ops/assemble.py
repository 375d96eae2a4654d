"""Normal-equation assembly.

Dense path (small/medium graphs): instead of the reference's per-edge Python
loop writing 2x2/3x3 blocks into a dense H under block indexing
(python/optimizer/graph_optimizer.py:94-141), or the CUDA kernels' atomicAdd
scatter (remote/cuda/optimizer/kernels/KernelSe2.cu:83-110), we scatter the
per-edge Jacobian blocks into one tall sparse-in-structure dense matrix
``J [R, D]`` (every residual row holds at most two small blocks) and form

    H = J^T (W J),    b = J^T (W r)

as a single matmul / matvec.  The products are deterministic (no atomics,
no mutex — compare OptimizerCpu.h:101-118) and the FLOPs land in one dense
matrix product.

``R = 3*E_odom + 2*E_lm`` and ``D = 3*N + 2*M``.  State layout: all pose
blocks first, then all landmark blocks — the same offset scheme the
reference's ``vertex_ids_map`` produces (graph_optimizer.py:95-103 with the
insertion order of slam_main.py:157-187).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from toyslam_tpu.models.graph import FactorGraph2D
from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import residuals as res_ops


class DenseSystem(NamedTuple):
    H: jax.Array      # f32[D, D]
    b: jax.Array      # f32[D] gradient J^T W r  (solve H dx = -b)
    err: jax.Array    # f32[]  total robustified chi^2
    fixed: jax.Array  # f32[D] 1.0 where the state entry belongs to a fixed vertex
    padded: jax.Array  # f32[D] 1.0 where the entry is padding


def state_masks(graph: FactorGraph2D) -> tuple[jax.Array, jax.Array]:
    """Expand per-vertex fixed/padding masks to the stacked state vector."""
    fixed = jnp.concatenate(
        [
            jnp.repeat(graph.pose_fixed, 3),
            jnp.repeat(graph.lm_fixed, 2),
        ]
    )
    padded = jnp.concatenate(
        [
            jnp.repeat(1.0 - graph.pose_mask, 3),
            jnp.repeat(1.0 - graph.lm_mask, 2),
        ]
    )
    return fixed, padded


def assemble_dense(
    graph: FactorGraph2D,
    huber_delta: float,
    fixed_prior: float = 1e6,
    exact_odom_jacobians: bool = False,
) -> DenseSystem:
    n, m = graph.num_poses, graph.num_landmarks
    e1, e2 = graph.odom.count, graph.lm_edges.count
    d = 3 * n + 2 * m
    r_rows = 3 * e1 + 2 * e2
    dtype = graph.poses.dtype

    od = res_ops.eval_odom_edges(
        graph.poses,
        graph.odom.i,
        graph.odom.j,
        graph.odom.meas,
        graph.odom.info,
        graph.odom.mask,
        huber_delta,
        exact=exact_odom_jacobians,
    )
    lme = res_ops.eval_landmark_edges(
        graph.poses,
        graph.landmarks,
        graph.lm_edges.pose,
        graph.lm_edges.lm,
        graph.lm_edges.meas,
        graph.lm_edges.info,
        graph.lm_edges.mask,
        huber_delta,
    )

    # Robustified information per edge; padded edges contribute zero via mask.
    w_od = (od.w)[:, None, None] * graph.odom.info
    w_lm = (lme.w)[:, None, None] * graph.lm_edges.info

    J = jnp.zeros((r_rows, d), dtype)
    WJ = jnp.zeros((r_rows, d), dtype)
    wr = jnp.zeros((r_rows,), dtype)

    # --- odometry edges: rows [3k, 3k+3), blocks at pose columns ----------
    rows1 = 3 * jnp.arange(e1, dtype=jnp.int32)[:, None] + jnp.arange(
        3, dtype=jnp.int32
    )
    cols_i = 3 * graph.odom.i[:, None] + jnp.arange(3, dtype=jnp.int32)
    cols_j = 3 * graph.odom.j[:, None] + jnp.arange(3, dtype=jnp.int32)
    mask1 = graph.odom.mask[:, None, None]
    WA1 = bm.mm(w_od, od.JA)
    WB1 = bm.mm(w_od, od.JB)
    J = J.at[rows1[:, :, None], cols_i[:, None, :]].add(od.JA * mask1)
    J = J.at[rows1[:, :, None], cols_j[:, None, :]].add(od.JB * mask1)
    WJ = WJ.at[rows1[:, :, None], cols_i[:, None, :]].add(WA1 * mask1)
    WJ = WJ.at[rows1[:, :, None], cols_j[:, None, :]].add(WB1 * mask1)
    wr = wr.at[rows1].add(
        bm.mv(w_od, od.r) * graph.odom.mask[:, None]
    )

    # --- landmark edges: rows [3E1 + 2k, ...), pose block + landmark block
    rows2 = (
        3 * e1
        + 2 * jnp.arange(e2, dtype=jnp.int32)[:, None]
        + jnp.arange(2, dtype=jnp.int32)
    )
    cols_p = 3 * graph.lm_edges.pose[:, None] + jnp.arange(3, dtype=jnp.int32)
    cols_l = (
        3 * n + 2 * graph.lm_edges.lm[:, None] + jnp.arange(2, dtype=jnp.int32)
    )
    mask2 = graph.lm_edges.mask[:, None, None]
    WA2 = bm.mm(w_lm, lme.JA)
    WB2 = bm.mm(w_lm, lme.JB)
    J = J.at[rows2[:, :, None], cols_p[:, None, :]].add(lme.JA * mask2)
    J = J.at[rows2[:, :, None], cols_l[:, None, :]].add(lme.JB * mask2)
    WJ = WJ.at[rows2[:, :, None], cols_p[:, None, :]].add(WA2 * mask2)
    WJ = WJ.at[rows2[:, :, None], cols_l[:, None, :]].add(WB2 * mask2)
    wr = wr.at[rows2].add(
        bm.mv(w_lm, lme.r) * graph.lm_edges.mask[:, None]
    )

    # --- one dense product does the heavy lifting.  HIGHEST keeps full
    # f32 accuracy (TF32 loses ~3 decimal digits, visible against the 1e6
    # gauge prior); the dense path serves small graphs so the extra cost
    # is irrelevant next to the O(D^3) solve.
    H = jnp.dot(
        J.T, WJ, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=dtype,
    )
    b = jnp.dot(
        J.T, wr, precision=jax.lax.Precision.HIGHEST,
        preferred_element_type=dtype,
    )

    fixed, padded = state_masks(graph)
    diag = jnp.diagonal(H)
    # Fixed vertices: strong prior on the diagonal, gradient entry zeroed
    # (graph_optimizer.py:146-150).  Padded entries get a unit diagonal so H
    # stays invertible; their gradient is already zero.
    H = H.at[jnp.arange(d), jnp.arange(d)].set(
        diag + fixed_prior * fixed + padded
    )
    b = b * (1.0 - fixed)

    err = jnp.sum(od.robust_err) + jnp.sum(lme.robust_err)
    return DenseSystem(H=H, b=b, err=err, fixed=fixed, padded=padded)


def total_error(
    graph: FactorGraph2D, huber_delta: float, exact_odom_jacobians: bool = False
) -> jax.Array:
    """Robustified chi^2 of the current state (no assembly)."""
    od = res_ops.eval_odom_edges(
        graph.poses,
        graph.odom.i,
        graph.odom.j,
        graph.odom.meas,
        graph.odom.info,
        graph.odom.mask,
        huber_delta,
        exact=exact_odom_jacobians,
    )
    lme = res_ops.eval_landmark_edges(
        graph.poses,
        graph.landmarks,
        graph.lm_edges.pose,
        graph.lm_edges.lm,
        graph.lm_edges.meas,
        graph.lm_edges.info,
        graph.lm_edges.mask,
        huber_delta,
    )
    return jnp.sum(od.robust_err) + jnp.sum(lme.robust_err)

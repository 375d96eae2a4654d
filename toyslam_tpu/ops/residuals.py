"""Batched residuals and analytic Jacobians for all edges of a type at once.

The reference evaluates edges one at a time through virtual ``calc_error``
methods (python/optimizer/edges2d.py:21-78; C++ remote/graph/edge/*.h; CUDA
one-thread-per-edge kernels remote/cuda/optimizer/kernels/KernelSe2.cu:37-112
and KernelSe2Point2.cu:46-155 with atomicAdd scatter).  Here each edge type is
a single batched closed-form computation over ``[E, ...]`` arrays — XLA fuses
the whole thing into a few elementwise kernels, and the downstream
accumulation is a
deterministic segment-sum/matmul instead of atomics or mutexes.

Jacobian conventions (matching the reference exactly):

* landmark edge (edges2d.py:21-53): residual
  ``r = R(th)^T (lm - t) - [d cos(b), d sin(b)]``; ``A = dr/d(pose)`` (2x3),
  ``B = dr/d(lm)`` (2x2) — the true analytic Jacobians.
* odometry edge (edges2d.py:65-78): residual from ``odom^-1 (p_i^-1 p_j)``;
  the reference approximates ``A = -I3, B = I3`` (also EdgeSe2.h:35 and
  KernelSe2.cu exploit this).  ``exact=True`` computes the true Jacobians of
  the residual expression instead.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import se2


class EdgeEval(NamedTuple):
    """Batched evaluation of one edge type.

    ``r``: f32[E, d] residuals; ``JA``: f32[E, d, da] Jacobian wrt the first
    vertex; ``JB``: f32[E, d, db] wrt the second; ``chi2``: f32[E] unrobust
    ``r^T W r``; ``w``: f32[E] Huber weight (1 inside the inlier region);
    ``robust_err``: f32[E] robustified chi^2 contribution.
    """

    r: jax.Array
    JA: jax.Array
    JB: jax.Array
    chi2: jax.Array
    w: jax.Array
    robust_err: jax.Array


def huber_weights(chi2: jax.Array, delta: float) -> tuple[jax.Array, jax.Array]:
    """Huber robustification applied to chi^2 (graph_optimizer.py:106-115).

    Returns ``(robust_err, weight)`` where for ``chi2 <= delta^2`` the edge is
    untouched (err=chi2, w=1) and beyond it ``err = 2 sqrt(chi2) delta -
    delta^2`` with ``w = delta / sqrt(chi2)`` scaling the information matrix.
    """
    delta_sq = delta * delta
    sqrt_e = jnp.sqrt(jnp.maximum(chi2, 1e-30))
    inlier = chi2 <= delta_sq
    robust_err = jnp.where(inlier, chi2, 2.0 * sqrt_e * delta - delta_sq)
    w = jnp.where(inlier, 1.0, delta / sqrt_e)
    return robust_err, w


def eval_odom_edges(
    poses: jax.Array,
    i: jax.Array,
    j: jax.Array,
    meas: jax.Array,
    info: jax.Array,
    mask: jax.Array,
    huber_delta: float,
    exact: bool = False,
) -> EdgeEval:
    """Residuals/Jacobians for all odometry edges.

    Residual (edges2d.py:71-73): ``delta = odom^-1 ⊕ (p_i^-1 ⊕ p_j)`` read out
    as (x, y, theta).
    """
    pi = poses[i]
    pj = poses[j]
    rel = se2.relative(pi, pj)
    delta = se2.compose(se2.inverse(meas), rel)
    r = delta  # already (x, y, wrapped theta)

    if exact:
        # True Jacobians of r(pose_i, pose_j) via autodiff of the closed form
        # (cheap: forward-mode over 3+3 inputs, fused by XLA).
        def _res(a, b, m):
            return se2.compose(se2.inverse(m), se2.relative(a, b))

        JA = jax.vmap(jax.jacfwd(_res, argnums=0))(pi, pj, meas)
        JB = jax.vmap(jax.jacfwd(_res, argnums=1))(pi, pj, meas)
    else:
        e = r.shape[0]
        eye = jnp.eye(3, dtype=r.dtype)
        JA = jnp.broadcast_to(-eye, (e, 3, 3))
        JB = jnp.broadcast_to(eye, (e, 3, 3))

    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)


def eval_landmark_edges(
    poses: jax.Array,
    landmarks: jax.Array,
    pose_idx: jax.Array,
    lm_idx: jax.Array,
    meas: jax.Array,
    info: jax.Array,
    mask: jax.Array,
    huber_delta: float,
) -> EdgeEval:
    """Residuals/Jacobians for all range-bearing landmark edges.

    Mirrors EdgeLandmark2d.calc_error (edges2d.py:21-53): residual is the
    landmark in the pose frame minus the measured body-frame point; A and B
    are the reference's closed-form Jacobians (which equal the true ones).
    """
    p = poses[pose_idx]           # [E, 3]
    lm = landmarks[lm_idx]        # [E, 2]
    pred = se2.inv_transform_point(p, lm)
    r = pred - se2.radial_to_euclidean(meas)

    c, s = jnp.cos(p[..., 2]), jnp.sin(p[..., 2])
    x1, y1 = p[..., 0], p[..., 1]
    lx, ly = lm[..., 0], lm[..., 1]
    # A[2,3] rows per edge (edges2d.py:39-47)
    a00, a01, a02 = -c, -s, c * ly - s * lx - c * y1 + s * x1
    a10, a11, a12 = s, -c, -s * ly - c * lx + s * y1 + c * x1
    JA = jnp.stack(
        [
            jnp.stack([a00, a01, a02], axis=-1),
            jnp.stack([a10, a11, a12], axis=-1),
        ],
        axis=-2,
    )
    # B[2,2] = R(th)^T (edges2d.py:49-53)
    JB = jnp.stack(
        [jnp.stack([c, s], axis=-1), jnp.stack([-s, c], axis=-1)], axis=-2
    )

    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)

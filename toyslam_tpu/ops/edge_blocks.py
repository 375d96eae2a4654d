"""Per-edge weighted normal-equation blocks — the linearization interface.

One Gauss-Newton linearization needs, for every edge, the Huber-weighted
Jacobian products that feed the block-sparse Hessian (``ops/schur.py``):

* odometry edge (A = -I, B = I approximation, reference
  python/optimizer/edges2d.py:75-77): the blocks collapse to ``±W'`` with
  ``W' = w * info`` and the gradient contribution to ``±W' r`` — exactly the
  structure the reference's CUDA kernel exploits
  (remote/cuda/optimizer/kernels/KernelSe2.cu:37-112);
* landmark edge (full analytic 2x3 / 2x2 Jacobians, edges2d.py:21-53):
  ``JA^T W' JA``, ``JB^T W' JB``, ``JA^T W' JB`` and the two gradient pieces
  (KernelSe2Point2.cu:46-155 is the CUDA analogue).

The blocks are batched jnp formulas (ops/residuals.py + ops/blockmath.py)
that XLA fuses.  Downstream accumulation is the deterministic gather-plan/segment-sum in
ops/schur.py either way — never atomics (compare KernelSe2.cu:83-110).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import residuals as res_ops


class OdomBlocks(NamedTuple):
    """Weighted linearization of all odometry edges (A=-I, B=I structure).

    ``w_info``: f32[E,3,3] = huber_w * mask * info — equals ``A^T W' A`` and
    ``B^T W' B``; the off-diagonal block is its negative. ``wr``: f32[E,3]
    = ``W' r``; the gradient contribution is ``-wr`` at vertex i, ``+wr`` at
    vertex j. ``robust_err``/``chi2``: masked per-edge error terms.
    """

    w_info: jax.Array
    wr: jax.Array
    robust_err: jax.Array
    chi2: jax.Array


class LmBlocks(NamedTuple):
    """Weighted linearization of all landmark edges.

    ``w_ata``: f32[E,3,3] = JA^T W' JA; ``w_btb``: f32[E,2,2] = JB^T W' JB;
    ``w_hpl``: f32[E,3,2] = JA^T W' JB; ``bp_c``: f32[E,3] = JA^T W' r;
    ``bl_c``: f32[E,2] = JB^T W' r, with W' = huber_w * mask * info.
    """

    w_ata: jax.Array
    w_btb: jax.Array
    w_hpl: jax.Array
    bp_c: jax.Array
    bl_c: jax.Array
    robust_err: jax.Array
    chi2: jax.Array


def odom_edge_blocks(
    poses: jax.Array,
    i: jax.Array,
    j: jax.Array,
    meas: jax.Array,
    info: jax.Array,
    mask: jax.Array,
    huber_delta: float,
    exact: bool = False,
) -> OdomBlocks:
    if exact:
        # Exact SE(2) Jacobians break the ±W' structure this interface
        # encodes; the schur assembler keeps its general ops.residuals path
        # for that (non-default) mode.
        raise ValueError(
            "odom_edge_blocks encodes the reference's A=-I/B=I structure; "
            "exact Jacobians go through ops.residuals directly"
        )
    od = res_ops.eval_odom_edges(
        poses, i, j, meas, info, mask, huber_delta, exact=False
    )
    w_info = od.w[:, None, None] * info
    wr = bm.mv(w_info, od.r)
    return OdomBlocks(
        w_info=w_info, wr=wr, robust_err=od.robust_err, chi2=od.chi2
    )


def lm_edge_blocks(
    poses: jax.Array,
    landmarks: jax.Array,
    pose_idx: jax.Array,
    lm_idx: jax.Array,
    meas: jax.Array,
    info: jax.Array,
    mask: jax.Array,
    huber_delta: float,
) -> LmBlocks:
    lme = res_ops.eval_landmark_edges(
        poses, landmarks, pose_idx, lm_idx, meas, info, mask, huber_delta
    )
    w_lm = lme.w[:, None, None] * info
    wjb = bm.mm(w_lm, lme.JB)
    wr = bm.mv(w_lm, lme.r)
    return LmBlocks(
        w_ata=bm.quad(lme.JA, w_lm),
        w_btb=bm.mtm(lme.JB, wjb),
        w_hpl=bm.mtm(lme.JA, wjb),
        bp_c=bm.mtv(lme.JA, wr),
        bl_c=bm.mtv(lme.JB, wr),
        robust_err=lme.robust_err,
        chi2=lme.chi2,
    )

"""SE(3) reprojection-edge linearization.

3D analogue of ops/edge_blocks.py: one call per edge *type* returns the
weighted Hessian/gradient blocks for every edge at once, as batched
formulas built on ops/residuals3d.py.  The reference has no 3D
capability; the CUDA analogue being replaced is the per-edge landmark
kernel remote/cuda/optimizer/kernels/KernelSe2Point2.cu:46-155 lifted to
6/3-dof blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import jax

from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import residuals3d as res3


class ReprojBlocks(NamedTuple):
    """Weighted linearization of all reprojection edges.

    ``w_ata``: f32[E,6,6] = JA^T W' JA; ``w_btb``: f32[E,3,3] = JB^T W' JB;
    ``w_hpl``: f32[E,6,3] = JA^T W' JB; ``bp_c``: f32[E,6] = JA^T W' r;
    ``bl_c``: f32[E,3] = JB^T W' r, with W' = huber_w * mask * info (2x2).
    """

    w_ata: jax.Array
    w_btb: jax.Array
    w_hpl: jax.Array
    bp_c: jax.Array
    bl_c: jax.Array
    robust_err: jax.Array
    chi2: jax.Array


def reproj_edge_blocks(
    poses: jax.Array,
    landmarks: jax.Array,
    intrinsics: jax.Array,
    pose_idx: jax.Array,
    lm_idx: jax.Array,
    meas: jax.Array,
    info: jax.Array,
    mask: jax.Array,
    huber_delta: float,
) -> ReprojBlocks:
    rp = res3.eval_reproj_edges(
        poses, landmarks, intrinsics, pose_idx, lm_idx, meas, info, mask,
        huber_delta,
    )
    w_rp = rp.w[:, None, None] * info               # [E,2,2]
    wjb = bm.mm(w_rp, rp.JB)                        # [E,2,3]
    wr = bm.mv(w_rp, rp.r)                          # [E,2]
    return ReprojBlocks(
        w_ata=bm.quad(rp.JA, w_rp),
        w_btb=bm.mtm(rp.JB, wjb),
        w_hpl=bm.mtm(rp.JA, wjb),
        bp_c=bm.mtv(rp.JA, wr),
        bl_c=bm.mtv(rp.JB, wr),
        robust_err=rp.robust_err,
        chi2=rp.chi2,
    )

"""Batched residuals/Jacobians for SE(3) edges: relative-pose + reprojection.

3D analogue of ops/residuals.py (the reference implements neither — its
roadmap names 3D as future work, reference README.md:52-56).  Jacobians are
taken with respect to the *tangent* update the optimizer applies
(``se3.retract``: additive translation, right-multiplied rotation), so the
GN step is consistent with the retraction.

* Relative-pose edge: residual ``log(meas^-1 · (T_i^-1 · T_j))`` read out in
  the decoupled (t, log R) chart.  ``exact=False`` mirrors the reference's
  2D odometry approximation A=-I, B=I (edges2d.py:75-77) lifted to 6-dof;
  ``exact=True`` differentiates the closed form with vmapped ``jacfwd``
  against tangent perturbations.
* Reprojection edge: pinhole projection of a world landmark into the camera
  at the pose (pose = camera-to-world).  Analytic 2x6 / 2x3 Jacobians —
  verified against autodiff in tests/test_se3.py.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from toyslam_tpu.ops import blockmath as bm
from toyslam_tpu.ops import se3
from toyslam_tpu.ops.precision import einsum
from toyslam_tpu.ops.residuals import EdgeEval, huber_weights


def _odom3d_residual(pi, pj, meas):
    return se3.log(se3.compose(se3.inverse(meas), se3.relative(pi, pj)))


def eval_odom3d_edges(
    poses: jax.Array,
    i: jax.Array,
    j: jax.Array,
    meas: jax.Array,
    info: jax.Array,
    mask: jax.Array,
    huber_delta: float,
    exact: bool = False,
) -> EdgeEval:
    pi = poses[i]
    pj = poses[j]
    r = _odom3d_residual(pi, pj, meas)

    if exact:
        def _res(eps_a, eps_b, a, b, m):
            return _odom3d_residual(
                se3.retract(a, eps_a), se3.retract(b, eps_b), m
            )

        zeros = jnp.zeros_like(r)
        JA = jax.vmap(jax.jacfwd(_res, argnums=0))(zeros, zeros, pi, pj, meas)
        JB = jax.vmap(jax.jacfwd(_res, argnums=1))(zeros, zeros, pi, pj, meas)
    else:
        e = r.shape[0]
        eye = jnp.eye(6, dtype=r.dtype)
        JA = jnp.broadcast_to(-eye, (e, 6, 6))
        JB = jnp.broadcast_to(eye, (e, 6, 6))

    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)


def project(intrinsics: jax.Array, x_cam: jax.Array) -> jax.Array:
    """Pinhole projection of camera-frame points ``[..., 3] -> [..., 2]``."""
    fx, fy, cx, cy = (
        intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    )
    z = jnp.maximum(x_cam[..., 2], 1e-6)
    u = fx * x_cam[..., 0] / z + cx
    v = fy * x_cam[..., 1] / z + cy
    return jnp.stack([u, v], axis=-1)


def eval_reproj_edges(
    poses: jax.Array,
    landmarks: jax.Array,
    intrinsics: jax.Array,
    pose_idx: jax.Array,
    lm_idx: jax.Array,
    meas: jax.Array,
    info: jax.Array,
    mask: jax.Array,
    huber_delta: float,
) -> EdgeEval:
    """Reprojection residual + analytic Jacobians wrt the retraction tangent.

    ``x_c = R^T (X - t)``; ``r = project(x_c) - meas``.
    ``d x_c / d dt = -R^T``; with the right-multiplied rotation update
    ``R <- R exp(omega^)``: ``d x_c / d omega = [x_c]_x``;
    ``d x_c / d X = R^T``.  ``JA = J_proj [ -R^T | [x_c]_x ]`` (2x6),
    ``JB = J_proj R^T`` (2x3).
    """
    p = poses[pose_idx]           # [E,12]
    X = landmarks[lm_idx]         # [E,3]
    R = se3.rot(p)
    Rt = jnp.swapaxes(R, -1, -2)
    x_c = einsum("...ij,...j->...i", Rt, X - se3.trans(p))
    r = project(intrinsics, x_c) - meas

    fx, fy = intrinsics[0], intrinsics[1]
    z = jnp.maximum(x_c[..., 2], 1e-6)
    inv_z = 1.0 / z
    x_z = x_c[..., 0] * inv_z
    y_z = x_c[..., 1] * inv_z
    zeros = jnp.zeros_like(z)
    # J_proj [E,2,3]
    jp = jnp.stack(
        [
            jnp.stack([fx * inv_z, zeros, -fx * x_z * inv_z], axis=-1),
            jnp.stack([zeros, fy * inv_z, -fy * y_z * inv_z], axis=-1),
        ],
        axis=-2,
    )
    d_dt = -Rt                                   # [E,3,3]
    d_om = se3.hat(x_c)                          # [E,3,3]
    JA = jnp.concatenate([bm.mm(jp, d_dt), bm.mm(jp, d_om)], axis=-1)
    JB = bm.mm(jp, Rt)

    chi2 = bm.vwv(r, info, r) * mask
    robust_err, w = huber_weights(chi2, huber_delta)
    return EdgeEval(r, JA, JB, chi2, w * mask, robust_err * mask)

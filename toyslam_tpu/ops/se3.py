"""SO(3)/SE(3) operations on flat ``[..., 12]`` pose arrays.

The reference's "further development" roadmap names 3D/SE(3) support
(reference README.md:52-56) but implements none of it; this module is the
3D analogue of ops/se2.py, designed array-first:

* a pose is ``[..., 12]`` — row-major rotation (9) then translation (3) —
  so batches are plain 2-D arrays that vmap/shard/gather cleanly (no
  quaternion renormalization subtleties in the hot path, no 4x4 padding);
* the optimizer's tangent step is ``[..., 6]`` = (dt, omega);
* retraction mirrors the 2D convention (additive translation + rotation
  recompose, reference python/optimizer/vertices.py:28-33):
  ``t' = t + dt``, ``R' = R @ exp(omega^)``.

All functions broadcast over leading batch dimensions.  Rodrigues formulas
use the numerically-safe small-angle series so gradients are finite at
theta = 0.  Products run at HIGHEST precision (ops/precision.py): they feed
the residuals, and a TF32 rotation product would put a ~1e-3 relative
error on every transformed point.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array

from toyslam_tpu.ops.precision import einsum

_EPS = 1e-8


def rot(pose: Array) -> Array:
    """``[..., 3, 3]`` rotation of a ``[..., 12]`` pose."""
    return pose[..., :9].reshape(pose.shape[:-1] + (3, 3))

def trans(pose: Array) -> Array:
    """``[..., 3]`` translation of a ``[..., 12]`` pose."""
    return pose[..., 9:12]


def make(R: Array, t: Array) -> Array:
    """Pack rotation + translation into the flat ``[..., 12]`` layout."""
    return jnp.concatenate(
        [R.reshape(R.shape[:-2] + (9,)), t], axis=-1
    )


def identity(batch_shape: tuple = (), dtype=jnp.float32) -> Array:
    eye = jnp.broadcast_to(
        jnp.eye(3, dtype=dtype).reshape(9), batch_shape + (9,)
    )
    return jnp.concatenate(
        [eye, jnp.zeros(batch_shape + (3,), dtype)], axis=-1
    )


def hat(w: Array) -> Array:
    """so(3) hat operator: ``[..., 3] -> [..., 3, 3]`` skew matrix."""
    z = jnp.zeros_like(w[..., 0])
    return jnp.stack(
        [
            jnp.stack([z, -w[..., 2], w[..., 1]], axis=-1),
            jnp.stack([w[..., 2], z, -w[..., 0]], axis=-1),
            jnp.stack([-w[..., 1], w[..., 0], z], axis=-1),
        ],
        axis=-2,
    )


def exp_so3(w: Array) -> Array:
    """Rodrigues: ``[..., 3] -> [..., 3, 3]``, safe at ``|w| -> 0``."""
    theta2 = jnp.sum(w * w, axis=-1)
    theta = jnp.sqrt(jnp.maximum(theta2, _EPS * _EPS))
    # sin(x)/x and (1-cos x)/x^2 with series fallbacks near zero
    small = theta2 < _EPS
    a = jnp.where(small, 1.0 - theta2 / 6.0, jnp.sin(theta) / theta)
    b = jnp.where(
        small, 0.5 - theta2 / 24.0, (1.0 - jnp.cos(theta)) / theta2
    )
    K = hat(w)
    KK = einsum("...ij,...jk->...ik", K, K)
    eye = jnp.broadcast_to(jnp.eye(3, dtype=w.dtype), K.shape)
    return eye + a[..., None, None] * K + b[..., None, None] * KK


def log_so3(R: Array) -> Array:
    """Inverse of :func:`exp_so3`: rotation matrix -> axis-angle ``[..., 3]``.

    Valid for rotation angles in [0, pi); the factor-graph residuals that
    use it operate on small relative rotations.
    """
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = jnp.clip((trace - 1.0) * 0.5, -1.0 + 1e-7, 1.0)
    w = 0.5 * jnp.stack(
        [
            R[..., 2, 1] - R[..., 1, 2],
            R[..., 0, 2] - R[..., 2, 0],
            R[..., 1, 0] - R[..., 0, 1],
        ],
        axis=-1,
    )
    # theta/sin(theta) with a gradient-safe small-angle series.  The naive
    # ``arccos`` has an infinite derivative at cos_t -> 1 which poisons
    # autodiff even through jnp.where (the optimizer differentiates this for
    # exact odometry Jacobians; an identity residual — common at init —
    # would turn the whole gradient NaN).  Double-where: the untaken branch
    # is evaluated at a safe argument so both primal and tangent stay finite.
    near_zero = cos_t > 1.0 - 1e-6
    safe_cos = jnp.where(near_zero, jnp.zeros_like(cos_t), cos_t)
    theta = jnp.arccos(safe_cos)
    # series: theta^2 ~= 2(1 - cos_t)  =>  theta/sin ~= 1 + (1 - cos_t)/3
    scale = jnp.where(
        near_zero,
        1.0 + (1.0 - cos_t) / 3.0,
        theta / jnp.sin(theta),
    )
    return w * scale[..., None]


def compose(a: Array, b: Array) -> Array:
    """Group product ``a · b`` on ``[..., 12]`` poses."""
    Ra, ta = rot(a), trans(a)
    Rb, tb = rot(b), trans(b)
    R = einsum("...ij,...jk->...ik", Ra, Rb)
    t = ta + einsum("...ij,...j->...i", Ra, tb)
    return make(R, t)


def inverse(a: Array) -> Array:
    Ra, ta = rot(a), trans(a)
    Rt = jnp.swapaxes(Ra, -1, -2)
    return make(Rt, -einsum("...ij,...j->...i", Rt, ta))


def relative(a: Array, b: Array) -> Array:
    """``a^-1 · b`` — the motion taking frame ``a`` to frame ``b``."""
    return compose(inverse(a), b)


def transform_point(pose: Array, pt: Array) -> Array:
    """World coordinates of a body-frame point."""
    return trans(pose) + einsum("...ij,...j->...i", rot(pose), pt)


def inv_transform_point(pose: Array, pt: Array) -> Array:
    """Body-frame coordinates of a world point: ``R^T (p - t)``."""
    d = pt - trans(pose)
    return einsum("...ji,...j->...i", rot(pose), d)


def retract(pose: Array, delta: Array) -> Array:
    """Tangent update ``[..., 6]`` = (dt, omega).

    Additive translation + rotation recompose — the SE(3) analogue of the
    reference's 2D vertex update (vertices.py:28-33): NOT the full SE(3)
    exponential (the translation is not coupled through V(omega)).
    """
    t = trans(pose) + delta[..., :3]
    R = einsum("...ij,...jk->...ik", rot(pose), exp_so3(delta[..., 3:6]))
    return make(R, t)


def log(pose: Array) -> Array:
    """Residual readout ``[..., 6]`` = (t, log_so3(R)) — the decoupled
    chart matching :func:`retract`."""
    return jnp.concatenate([trans(pose), log_so3(rot(pose))], axis=-1)


def orthonormalize(pose: Array) -> Array:
    """Project the rotation back onto SO(3) (Gram-Schmidt on rows).

    Long optimization runs accumulate drift in the 9-float rotation; calling
    this between GN iterations (cheap, elementwise) keeps R orthogonal.
    """
    R = rot(pose)
    r0 = R[..., 0, :]
    r0 = r0 / jnp.linalg.norm(r0, axis=-1, keepdims=True)
    r1 = R[..., 1, :]
    r1 = r1 - jnp.sum(r0 * r1, axis=-1, keepdims=True) * r0
    r1 = r1 / jnp.linalg.norm(r1, axis=-1, keepdims=True)
    r2 = jnp.cross(r0, r1)
    return make(jnp.stack([r0, r1, r2], axis=-2), trans(pose))

"""SE(2) operations on ``[..., 3]`` arrays of ``(x, y, theta)``.

The reference stores poses as 3x3 homogeneous matrices and converts back and
forth through scipy rotations (reference python/tools.py:6-42, and the C++
equivalents remote/graph/Helper.h:6-31).  A compact ``(x, y, theta)``
parameterization is strictly better: it is the same 3-dof tangent space the
optimizer updates, retraction is elementwise, and batches of poses are plain
``[N, 3]`` arrays that vmap/shard cleanly.  Homogeneous-matrix converters are
provided for interop (wire codec, visualization).

All functions broadcast over leading batch dimensions.
"""

from __future__ import annotations

import jax.numpy as jnp
from jax import Array


def wrap_angle(theta: Array) -> Array:
    """Wrap angles to (-pi, pi].

    The reference never wraps explicitly; it relies on ``atan2`` when reading
    angles back out of rotation matrices (tools.py:6-12, Helper.h:21-24).
    Wrapping after every compose/retract is the equivalent invariant for the
    ``(x, y, theta)`` parameterization.
    """
    return jnp.arctan2(jnp.sin(theta), jnp.cos(theta))


def rotation(theta: Array) -> Array:
    """``[..., 2, 2]`` rotation matrix for ``[...]`` angles."""
    c, s = jnp.cos(theta), jnp.sin(theta)
    return jnp.stack(
        [jnp.stack([c, -s], axis=-1), jnp.stack([s, c], axis=-1)], axis=-2
    )


def identity(batch_shape: tuple = (), dtype=jnp.float32) -> Array:
    return jnp.zeros(batch_shape + (3,), dtype=dtype)


def compose(a: Array, b: Array) -> Array:
    """Group product ``a ⊕ b`` (reference motion_model, slam_helper.py:18-19)."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = a[..., 0] + ca * b[..., 0] - sa * b[..., 1]
    y = a[..., 1] + sa * b[..., 0] + ca * b[..., 1]
    th = wrap_angle(a[..., 2] + b[..., 2])
    return jnp.stack([x, y, th], axis=-1)


def inverse(a: Array) -> Array:
    """Group inverse (reference InverseTransform2d, Helper.h:26-31)."""
    ca, sa = jnp.cos(a[..., 2]), jnp.sin(a[..., 2])
    x = -(ca * a[..., 0] + sa * a[..., 1])
    y = -(-sa * a[..., 0] + ca * a[..., 1])
    return jnp.stack([x, y, -a[..., 2]], axis=-1)


def transform_point(pose: Array, pt: Array) -> Array:
    """World coordinates of a body-frame point (tools.py:37-42)."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    x = pose[..., 0] + c * pt[..., 0] - s * pt[..., 1]
    y = pose[..., 1] + s * pt[..., 0] + c * pt[..., 1]
    return jnp.stack([x, y], axis=-1)


def inv_transform_point(pose: Array, pt: Array) -> Array:
    """Body-frame coordinates of a world point (edges2d.py:28: ``pos^-1 @ lm``)."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    dx = pt[..., 0] - pose[..., 0]
    dy = pt[..., 1] - pose[..., 1]
    return jnp.stack([c * dx + s * dy, -s * dx + c * dy], axis=-1)


def retract(pose: Array, delta: Array) -> Array:
    """Additive-xy, angle-recompose retraction.

    Matches the reference vertex update exactly (vertices.py:28-33,
    VertexSe2.h:16-27, KernelCommon.cu:28-45): xy is updated additively and
    theta is re-composed, i.e. this is NOT the SE(2) exponential map.
    """
    return jnp.stack(
        [
            pose[..., 0] + delta[..., 0],
            pose[..., 1] + delta[..., 1],
            wrap_angle(pose[..., 2] + delta[..., 2]),
        ],
        axis=-1,
    )


def to_matrix(pose: Array) -> Array:
    """``[..., 3, 3]`` homogeneous matrix."""
    c, s = jnp.cos(pose[..., 2]), jnp.sin(pose[..., 2])
    z = jnp.zeros_like(c)
    o = jnp.ones_like(c)
    rows = [
        jnp.stack([c, -s, pose[..., 0]], axis=-1),
        jnp.stack([s, c, pose[..., 1]], axis=-1),
        jnp.stack([z, z, o], axis=-1),
    ]
    return jnp.stack(rows, axis=-2)


def from_matrix(mat: Array) -> Array:
    """Inverse of :func:`to_matrix` (theta via atan2, Helper.h:21-24)."""
    theta = jnp.arctan2(mat[..., 1, 0], mat[..., 0, 0])
    return jnp.stack([mat[..., 0, 2], mat[..., 1, 2], theta], axis=-1)


def relative(a: Array, b: Array) -> Array:
    """``a^-1 ⊕ b`` — the motion taking frame ``a`` to frame ``b``."""
    return compose(inverse(a), b)


def radial_to_euclidean(meas: Array) -> Array:
    """(range, bearing) -> body-frame (x, y) (tools.py:33-36)."""
    return jnp.stack(
        [
            meas[..., 0] * jnp.cos(meas[..., 1]),
            meas[..., 0] * jnp.sin(meas[..., 1]),
        ],
        axis=-1,
    )


def euclidean_to_radial(pt: Array) -> Array:
    """Body-frame (x, y) -> (range, bearing) (tools.py:25-27)."""
    rng = jnp.sqrt(pt[..., 0] ** 2 + pt[..., 1] ** 2)
    ang = jnp.arctan2(pt[..., 1], pt[..., 0])
    return jnp.stack([rng, ang], axis=-1)

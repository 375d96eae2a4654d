"""Vectorized 2D LiDAR against circular obstacles.

The reference ray-casts with an O(rays x points) nested Python loop
(python/lidar_sensor.py:51-113) — its hottest frontend path.  Here every
(ray, obstacle) pair is one lane of a single ``[R, P]`` batched
intersection; the closest hit per ray is an ``argmin``.  For the reference
workload (20 rays x 422 points x 150 poses) the whole trajectory's scans are
one fused XLA computation.

Semantics matched to the reference:

* ray-circle intersection via the discriminant test then smallest
  non-negative root (lidar_sensor.py:22-49);
* the returned hit point lies along the direction to the circle *center* at
  the ray's root distance — the reference recomputes ``dir`` from the center
  before placing the point (lidar_sensor.py:84-88), so the measured bearing
  is the bearing of the obstacle center, and the measured range is the ray
  root;
* measurement is (range, bearing) relative to the robot pose with the
  ground-truth obstacle id for association (lidar_sensor.py:105-108) —
  data association by ID is the reference's explicit simplification
  (README.md:49-50).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from toyslam_tpu.ops import se2

BIG = 1e9


@functools.partial(jax.jit, static_argnames=("ray_count",))
def scan_pose(
    pose: jax.Array,
    env: jax.Array,
    radius: jax.Array | float,
    fov: jax.Array | float,
    ray_count: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Scan from one pose.

    Returns ``(meas [R, 2] (range, bearing), ids [R] i32, valid [R] bool)``.
    Ray angles span ``[theta - fov/2, theta + fov/2]`` inclusive with
    ``ray_count`` rays (linspace, matching lidar_sensor.py:66-74).
    """
    origin = pose[:2]
    theta = pose[2]
    angles = theta + jnp.linspace(-0.5 * fov, 0.5 * fov, ray_count)
    dirs = jnp.stack([jnp.cos(angles), jnp.sin(angles)], axis=-1)  # [R,2]

    oc = env[None, :, :] - origin[None, None, :]          # [R?broadcast P,2]
    # HIGHEST: the ray-circle distances become range measurements; TF32
    # would put a ~1e-3 relative error on them, above the sensor noise
    tca = jnp.einsum("rd,pd->rp", dirs, env - origin,
                     precision=jax.lax.Precision.HIGHEST)  # [R,P]
    d2 = jnp.sum((env - origin) ** 2, axis=-1)[None, :] - tca**2
    r2 = radius * radius
    thc = jnp.sqrt(jnp.maximum(r2 - d2, 0.0))
    t0 = tca - thc
    t1 = tca + thc
    t = jnp.where(t0 < 0.0, t1, t0)
    hit = (d2 <= r2) & (t1 >= 0.0)
    t = jnp.where(hit, t, BIG)

    best = jnp.argmin(t, axis=1)                          # [R]
    t_best = jnp.take_along_axis(t, best[:, None], axis=1)[:, 0]
    valid = t_best < BIG

    centers = env[best]                                   # [R,2]
    to_center = centers - origin[None, :]
    center_bearing = jnp.arctan2(to_center[:, 1], to_center[:, 0])
    bearing = se2.wrap_angle(center_bearing - theta)
    meas = jnp.stack([t_best, bearing], axis=-1)
    meas = jnp.where(valid[:, None], meas, 0.0)
    ids = jnp.where(valid, best.astype(jnp.int32), -1)
    return meas, ids, valid


@functools.partial(jax.jit, static_argnames=("ray_count",))
def scan_trajectory(
    poses: jax.Array,
    env: jax.Array,
    radius: jax.Array | float,
    fov: jax.Array | float,
    ray_count: int,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """vmapped scans for a whole trajectory: ``[T, R, ...]`` outputs."""
    return jax.vmap(
        lambda p: scan_pose(p, env, radius, fov, ray_count)
    )(poses)


def scan_trajectory_np(
    poses, env, radius: float, fov: float, ray_count: int
):
    """Float64 numpy scan — bit-identical on every platform.

    Grazing rays sit exactly on the ``d2 <= r^2`` decision boundary; in f32
    the boundary flips between backends (different fma contraction), which
    changes hit IDs and hence the *problem instance*.  The frontend is
    host-side setup (as in the reference, whose whole frontend is numpy
    float64), so the deterministic f64 version is the default for graph
    construction; the JAX version above serves on-device pipelines and is
    tested against this one.

    Vectorized over ``[T, R, P]`` in one shot — same math as
    :func:`scan_pose`.
    """
    import numpy as np

    poses = np.asarray(poses, np.float64)       # [T,3]
    env = np.asarray(env, np.float64)           # [P,2]
    T = poses.shape[0]
    origin = poses[:, :2]                       # [T,2]
    theta = poses[:, 2]                         # [T]
    rel = np.linspace(-0.5 * fov, 0.5 * fov, ray_count)
    ang = theta[:, None] + rel[None, :]         # [T,R]
    dirs = np.stack([np.cos(ang), np.sin(ang)], axis=-1)  # [T,R,2]

    oc = env[None, :, :] - origin[:, None, :]   # [T,P,2]
    tca = np.einsum("trd,tpd->trp", dirs, oc)   # [T,R,P]
    d2 = np.sum(oc * oc, axis=-1)[:, None, :] - tca**2
    r2 = radius * radius
    thc = np.sqrt(np.maximum(r2 - d2, 0.0))
    t0, t1 = tca - thc, tca + thc
    t = np.where(t0 < 0.0, t1, t0)
    hit = (d2 <= r2) & (t1 >= 0.0)
    t = np.where(hit, t, BIG)

    best = np.argmin(t, axis=2)                               # [T,R]
    t_best = np.take_along_axis(t, best[..., None], axis=2)[..., 0]
    valid = t_best < BIG

    centers = env[best]                                       # [T,R,2]
    to_c = centers - origin[:, None, :]
    bearing = np.arctan2(to_c[..., 1], to_c[..., 0]) - theta[:, None]
    bearing = np.arctan2(np.sin(bearing), np.cos(bearing))
    meas = np.stack([t_best, bearing], axis=-1)
    meas = np.where(valid[..., None], meas, 0.0).astype(np.float32)
    ids = np.where(valid, best, -1).astype(np.int32)
    return meas, ids, valid

"""SLAM frontend: run the simulated robot and build the factor graph.

Replaces the reference's per-frame ``step()`` accumulation into ``Graph2d``
and its later conversion to the optimization graph
(python/slam_main.py:99-187, python/slam/slam_helper.py:4-19).

Two simulation paths:

* :func:`simulate` (default) — **deterministic host frontend**: float64
  numpy geometry + a seeded numpy RNG, bit-identical on every platform.
  This mirrors the reference's architecture (its whole frontend is numpy
  float64 on the host; only optimization is offloaded) and guarantees the
  benchmark problem instance is the same no matter which backend builds it.
  f32 backends disagree in the last ulp of trig/fma, which flips grazing-ray
  hit decisions and silently changes the problem (observed: chi^2 135428 vs
  116126 for the "same" seed).
* :func:`simulate_jax` — the fully-on-device pipeline (fused XLA sim) for
  workloads that want scan generation on the accelerator itself.

Noise semantics matched to the reference:

* odometry: additive Gaussian on each step transform's (dx, dy, dtheta)
  (slam_main.py:137-142);
* landmarks: noise added to the *body-frame euclidean* point, re-encoded as
  (range, bearing) for the measurement, pushed through the *dead-reckoned*
  pose for the landmark's first-seen global estimate (slam_helper.py:4-16);
* the first pose is gauge-fixed (slam_main.py:87).
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from toyslam_tpu.config import SimConfig, SlamConfig
from toyslam_tpu.models.graph import FactorGraph2D, GraphBuilder2D
from toyslam_tpu.ops import se2
from toyslam_tpu.sim import environment as env_mod
from toyslam_tpu.sim import lidar, trajectory


class SimulationResult(NamedTuple):
    poses_gt: np.ndarray   # f32[T,3] ground-truth trajectory
    poses_dr: np.ndarray   # f32[T,3] dead-reckoned (noisy odometry) trajectory
    odom_gt: np.ndarray    # f32[T-1,3] scripted controls
    odom_meas: np.ndarray  # f32[T-1,3] noisy odometry measurements
    meas: np.ndarray       # f32[T,R,2] noisy (range, bearing) per ray
    meas_gt: np.ndarray    # f32[T,R,2] noise-free measurements
    lm_global: np.ndarray  # f32[T,R,2] first-seen candidate world estimates
    ids: np.ndarray        # i32[T,R] ground-truth obstacle id (-1 invalid)
    valid: np.ndarray      # bool[T,R]
    env: np.ndarray        # f32[P,2]
    radius: float


def _integrate_np(start: np.ndarray, controls: np.ndarray) -> np.ndarray:
    """Float64 sequential SE(2) compose (tiny: one pass over the tape)."""
    out = np.empty((controls.shape[0] + 1, 3), np.float64)
    out[0] = start
    x, y, th = start
    for k, (dx, dy, dth) in enumerate(controls):
        c, s = np.cos(th), np.sin(th)
        x, y = x + c * dx - s * dy, y + s * dx + c * dy
        th = np.arctan2(np.sin(th + dth), np.cos(th + dth))
        out[k + 1] = (x, y, th)
    return out


def simulate(
    config: SimConfig,
    rng: Optional[np.random.Generator] = None,
    controls: Optional[np.ndarray] = None,
) -> SimulationResult:
    """Deterministic host-side simulation (float64 numpy).

    ``controls`` overrides the reference's scripted schedule — e.g.
    ``sim.synthetic.multi_loop_controls`` for the multi-loop/loop-closure
    workload.
    """
    if rng is None:
        rng = np.random.default_rng(config.seed)
    env, radius = env_mod.load_environment()
    if controls is None:
        controls = trajectory.scripted_controls(config.robot_steps - 1)
    controls = np.asarray(controls, np.float64)
    start = np.array(
        [config.start_xy[0], config.start_xy[1], config.start_theta],
        np.float64,
    )
    lidar_scale, pos_scale, ang_scale = config.noise.sample_scales()

    poses_gt = _integrate_np(start, controls)
    meas_gt, ids, valid = lidar.scan_trajectory_np(
        poses_gt, env, radius, config.lidar.fov, config.lidar.ray_count
    )

    odom_meas = controls + rng.normal(
        0.0, [pos_scale, pos_scale, ang_scale], controls.shape
    )
    odom_meas[:, 2] = np.arctan2(
        np.sin(odom_meas[:, 2]), np.cos(odom_meas[:, 2])
    )
    poses_dr = _integrate_np(start, odom_meas)

    mg = meas_gt.astype(np.float64)
    local = np.stack(
        [mg[..., 0] * np.cos(mg[..., 1]), mg[..., 0] * np.sin(mg[..., 1])],
        axis=-1,
    )
    local = local + rng.normal(0.0, lidar_scale, local.shape)
    meas = np.stack(
        [
            np.linalg.norm(local, axis=-1),
            np.arctan2(local[..., 1], local[..., 0]),
        ],
        axis=-1,
    )
    c = np.cos(poses_dr[:, 2])[:, None]
    s = np.sin(poses_dr[:, 2])[:, None]
    lm_global = np.stack(
        [
            poses_dr[:, 0][:, None] + c * local[..., 0] - s * local[..., 1],
            poses_dr[:, 1][:, None] + s * local[..., 0] + c * local[..., 1],
        ],
        axis=-1,
    )
    return SimulationResult(
        poses_gt=poses_gt.astype(np.float32),
        poses_dr=poses_dr.astype(np.float32),
        odom_gt=controls.astype(np.float32),
        odom_meas=odom_meas.astype(np.float32),
        meas=meas.astype(np.float32),
        meas_gt=meas_gt,
        lm_global=lm_global.astype(np.float32),
        ids=ids,
        valid=valid,
        env=env,
        radius=radius,
    )


@functools.partial(jax.jit, static_argnames=("ray_count", "num_steps"))
def _simulate_core_jax(
    key: jax.Array,
    start: jax.Array,
    controls: jax.Array,
    env: jax.Array,
    radius: float,
    fov: float,
    ray_count: int,
    lidar_scale: float,
    pos_scale: float,
    ang_scale: float,
    num_steps: int,
):
    poses_gt = trajectory.integrate(start, controls)
    meas_gt, ids, valid = lidar.scan_trajectory(
        poses_gt, env, radius, fov, ray_count
    )

    k_odom, k_lm = jax.random.split(key)
    scales = jnp.asarray([pos_scale, pos_scale, ang_scale], controls.dtype)
    odom_meas = controls + jax.random.normal(
        k_odom, controls.shape, controls.dtype
    ) * scales
    odom_meas = odom_meas.at[:, 2].set(se2.wrap_angle(odom_meas[:, 2]))
    poses_dr = trajectory.integrate(start, odom_meas)

    local = se2.radial_to_euclidean(meas_gt)                 # [T,R,2]
    local = local + jax.random.normal(k_lm, local.shape) * lidar_scale
    meas = se2.euclidean_to_radial(local)
    lm_global = se2.transform_point(poses_dr[:, None, :], local)
    return poses_gt, poses_dr, odom_meas, meas, meas_gt, lm_global, ids, valid


def simulate_jax(
    config: SimConfig, key: Optional[jax.Array] = None
) -> SimulationResult:
    """Fully-on-device simulation (fused XLA).  Same distributions as
    :func:`simulate` but not bit-identical across platforms (f32 trig/fma
    and knife-edge hit decisions differ per backend)."""
    if key is None:
        key = jax.random.PRNGKey(config.seed)
    env, radius = env_mod.load_environment()
    controls = jnp.asarray(
        trajectory.scripted_controls(config.robot_steps - 1)
    )
    start = jnp.asarray(
        [config.start_xy[0], config.start_xy[1], config.start_theta],
        jnp.float32,
    )
    lidar_scale, pos_scale, ang_scale = config.noise.sample_scales()
    out = _simulate_core_jax(
        key,
        start,
        jnp.asarray(controls),
        jnp.asarray(env),
        radius,
        config.lidar.fov,
        config.lidar.ray_count,
        lidar_scale,
        pos_scale,
        ang_scale,
        config.robot_steps,
    )
    poses_gt, poses_dr, odom_meas, meas, meas_gt, lm_global, ids, valid = (
        np.asarray(x) for x in out
    )
    return SimulationResult(
        poses_gt=poses_gt,
        poses_dr=poses_dr,
        odom_gt=np.asarray(controls),
        odom_meas=odom_meas,
        meas=meas,
        meas_gt=meas_gt,
        lm_global=lm_global,
        ids=ids,
        valid=valid,
        env=np.asarray(env),
        radius=radius,
    )


def build_graph(
    sim: SimulationResult,
    config: SlamConfig,
) -> tuple[FactorGraph2D, dict[int, int]]:
    """Assemble the optimization problem from a simulation run.

    Mirrors construct_optimizer_graph (slam_main.py:157-187): pose vertices
    are the dead-reckoned states, odometry edges carry the noisy step
    transforms with the odometry information matrix, landmark edges carry the
    noisy (range, bearing) measurements with the LiDAR information matrix,
    and landmark vertices are initialized at their first-seen global
    estimate.  Returns the graph and the obstacle-id -> landmark-index map.
    """
    noise = config.sim.noise
    odom_info = np.diag(noise.odom_information_diag()).astype(np.float32)
    lm_info = np.diag(noise.lidar_information_diag()).astype(np.float32)

    poses_dr = np.asarray(sim.poses_dr)
    odom_meas = np.asarray(sim.odom_meas)
    meas = np.asarray(sim.meas)
    lm_global = np.asarray(sim.lm_global)
    ids = np.asarray(sim.ids)
    valid = np.asarray(sim.valid)

    b = GraphBuilder2D(
        pose_bucket=config.pose_bucket,
        landmark_bucket=config.landmark_bucket,
        edge_bucket=config.edge_bucket,
    )
    T = poses_dr.shape[0]
    for t in range(T):
        b.add_pose(poses_dr[t], fixed=(t == 0))
    for t in range(T - 1):
        b.add_odom_edge(t, t + 1, odom_meas[t], odom_info)
    for t in range(T):
        for r in np.nonzero(valid[t])[0]:
            oid = int(ids[t, r])
            b.add_landmark(oid, lm_global[t, r])  # first-seen estimate wins
            b.add_landmark_edge(t, oid, meas[t, r], lm_info)
    return b.build(), b.landmark_id_map


def ate_rmse(poses_est: np.ndarray, poses_gt: np.ndarray) -> float:
    """Absolute trajectory error (RMSE over xy), the headline metric."""
    d = np.asarray(poses_est)[:, :2] - np.asarray(poses_gt)[:, :2]
    return float(np.sqrt(np.mean(np.sum(d * d, axis=1))))

"""Live incremental SLAM loop — the reference's per-frame runtime shape.

The reference's defining loop (reference python/slam_main.py:99-155 and the
asyncio render loop at :240-274) is: per frame, move the robot along the
scripted schedule, ray-cast a LiDAR scan, sample noisy odometry, insert the
frame into the graph, and update the live views; optimization runs at the
end (or on demand) and writes the optimized vertices back
(slam_main.py:196-213 ``update_graph``).

:class:`LiveSlam` reproduces that runtime shape on the array-native stack:
frames accumulate into a :class:`GraphBuilder2D` (bucketed shapes, so the
periodic re-optimizations re-jit only when a bucket boundary is crossed),
optimization is the batched JAX Gauss-Newton (or a remote graph server via
``optimize_fn``), and the optimized state is written back into the builder
so later frames extend the refined estimate.

Noise-stream note: the batch frontend (sim/frontend.py ``simulate``) draws
all odometry noise, then all LiDAR noise; the live loop draws per frame
(odometry then LiDAR, interleaved), so the two produce different (equally
distributed) problem instances for the same seed.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from toyslam_tpu.config import SlamConfig
from toyslam_tpu.models.graph import FactorGraph2D, GraphBuilder2D
from toyslam_tpu.sim import environment as env_mod
from toyslam_tpu.sim import lidar, trajectory


def _compose(pose, delta):
    x, y, th = pose
    dx, dy, dth = delta
    c, s = np.cos(th), np.sin(th)
    return np.array(
        [
            x + c * dx - s * dy,
            y + s * dx + c * dy,
            np.arctan2(np.sin(th + dth), np.cos(th + dth)),
        ],
        np.float64,
    )


class LiveSlam:
    """Frame-at-a-time SLAM driver (reference slam_main.py:99-155 parity)."""

    def __init__(
        self,
        config: SlamConfig,
        controls: Optional[np.ndarray] = None,
        rng: Optional[np.random.Generator] = None,
    ):
        self.config = config
        self.rng = rng or np.random.default_rng(config.sim.seed)
        self.env, self.radius = env_mod.load_environment()
        if controls is None:
            controls = trajectory.scripted_controls(
                config.sim.robot_steps - 1
            )
        self.controls = np.asarray(controls, np.float64)
        sx, sy = config.sim.start_xy
        self.pose_gt = np.array([sx, sy, config.sim.start_theta], np.float64)
        self.pose_dr = self.pose_gt.copy()
        self.builder = GraphBuilder2D(
            pose_bucket=config.pose_bucket,
            landmark_bucket=config.landmark_bucket,
            edge_bucket=config.edge_bucket,
        )
        self.builder.add_pose(self.pose_dr, fixed=True)
        self.frame = 0
        self.traj_gt = [self.pose_gt.copy()]
        self.traj_dr = [self.pose_dr.copy()]
        self.last_scan_local: Optional[np.ndarray] = None
        noise = config.sim.noise
        self._odom_info = np.diag(noise.odom_information_diag()).astype(
            np.float32
        )
        self._lm_info = np.diag(noise.lidar_information_diag()).astype(
            np.float32
        )
        self._lidar_scale, self._pos_scale, self._ang_scale = (
            noise.sample_scales()
        )

    @property
    def done(self) -> bool:
        return self.frame >= self.controls.shape[0]

    def step(self) -> bool:
        """One frame: move -> scan -> noisy odometry -> graph insert.

        Returns False when the schedule is exhausted.
        """
        if self.done:
            return False
        control = self.controls[self.frame]
        self.pose_gt = _compose(self.pose_gt, control)

        # LiDAR scan at the new GT pose (reference slam_main.py:127-135)
        lcfg = self.config.sim.lidar
        meas_gt, ids, valid = lidar.scan_trajectory_np(
            self.pose_gt[None], self.env, self.radius, lcfg.fov,
            lcfg.ray_count,
        )
        meas_gt, ids, valid = meas_gt[0], ids[0], valid[0]

        # noisy odometry (slam_main.py:137-144)
        odom_meas = control + self.rng.normal(
            0.0, [self._pos_scale, self._pos_scale, self._ang_scale]
        )
        odom_meas[2] = np.arctan2(np.sin(odom_meas[2]), np.cos(odom_meas[2]))
        self.pose_dr = _compose(self.pose_dr, odom_meas)
        t = self.builder.add_pose(self.pose_dr)
        self.builder.add_odom_edge(
            t - 1, t, odom_meas.astype(np.float32), self._odom_info
        )

        # noisy landmark observations in the body frame (slam_helper.py:4-16)
        local = np.stack(
            [
                meas_gt[:, 0] * np.cos(meas_gt[:, 1]),
                meas_gt[:, 0] * np.sin(meas_gt[:, 1]),
            ],
            axis=-1,
        )
        local = local + self.rng.normal(0.0, self._lidar_scale, local.shape)
        rng_n = np.linalg.norm(local, axis=-1)
        brg_n = np.arctan2(local[:, 1], local[:, 0])
        c, s = np.cos(self.pose_dr[2]), np.sin(self.pose_dr[2])
        world = np.stack(
            [
                self.pose_dr[0] + c * local[:, 0] - s * local[:, 1],
                self.pose_dr[1] + s * local[:, 0] + c * local[:, 1],
            ],
            axis=-1,
        )
        for r in np.nonzero(valid)[0]:
            oid = int(ids[r])
            self.builder.add_landmark(oid, world[r].astype(np.float32))
            self.builder.add_landmark_edge(
                t, oid,
                np.array([rng_n[r], brg_n[r]], np.float32),
                self._lm_info,
            )

        self.last_scan_local = local[valid]
        self.traj_gt.append(self.pose_gt.copy())
        self.traj_dr.append(self.pose_dr.copy())
        self.frame += 1
        return True

    def graph(self) -> FactorGraph2D:
        return self.builder.build()

    def optimize(
        self,
        optimize_fn: Callable[[FactorGraph2D], FactorGraph2D],
    ) -> FactorGraph2D:
        """Optimize the current graph and write the result back into the
        builder (reference ``update_graph``, slam_main.py:196-213), so
        subsequent frames extend the refined trajectory/map."""
        out = optimize_fn(self.graph())
        n = self.builder.num_poses
        m = self.builder.num_landmarks
        poses = np.asarray(out.poses)[:n]
        lms = np.asarray(out.landmarks)[:m]
        self.builder.set_state(poses, lms)
        self.pose_dr = poses[-1].astype(np.float64)
        return out


def attach_views(live: LiveSlam, view):
    """Wire the four live views of the reference UI (slam_main.py:68-84)
    onto a ``view.View``; returns an ``update(opt_graph=None)`` closure."""
    from toyslam_tpu.view.view2d import (
        FootprintView2d, GraphView2d, RobotStateView,
    )

    view.ax.scatter(
        live.env[:, 0], live.env[:, 1], s=4, c="dimgray", alpha=0.6,
        label="environment",
    )
    robot_gt = RobotStateView(view, live.config.sim.lidar.fov,
                              color="tab:green", label="robot (gt)")
    robot_est = RobotStateView(view, live.config.sim.lidar.fov,
                               color="tab:red", label="robot (est)")
    trail = FootprintView2d(view)
    graph_view = GraphView2d(view)
    view.legend()

    def update(opt_graph: Optional[FactorGraph2D] = None):
        robot_gt.update(live.pose_gt, live.last_scan_local)
        robot_est.update(live.pose_dr)
        trail.update(np.asarray(live.traj_gt))
        if opt_graph is not None:
            graph_view.update(
                opt_graph.poses, opt_graph.landmarks,
                opt_graph.pose_mask, opt_graph.lm_mask,
            )
        view.draw()

    return update

"""Typed configuration for the whole framework.

The reference scatters its configuration across module-level constants
(reference python/slam_main.py:26-51), hardcoded magic numbers replicated in
three backends (Huber delta=1.5, step scale 0.2, fixed prior 1e6, convergence
eps=0.001 — reference python/optimizer/graph_optimizer.py:108,149,90 and
remote/optimizer/OptimizerCpu.h:92,164,136,167), and positional argv on the
C++ server (reference remote/app/main.cpp:12-16).  Here every knob is a named
field on a frozen dataclass so a single object configures the simulator, the
frontend and the optimizer consistently.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional


@dataclasses.dataclass(frozen=True)
class LidarConfig:
    """Simulated 2D LiDAR (reference python/slam_main.py:33-36).

    ``fov``/``ray_step`` are radians.  ``ray_count = int(fov / ray_step)``
    mirrors the reference's ray enumeration (lidar_sensor.py:73-74).
    """

    fov: float = math.radians(120.0)
    ray_step: float = math.radians(6.0)
    range_std: float = 0.15
    max_range: float = 999999.0

    @property
    def ray_count(self) -> int:
        return int(self.fov / self.ray_step)


@dataclasses.dataclass(frozen=True)
class NoiseConfig:
    """Sensor noise model (reference python/slam_main.py:36-51).

    The reference has a documented quirk: it passes *variances* where numpy
    expects standard deviations when sampling odometry/landmark noise
    (slam_main.py:137-141 passes ``ODOMETRY_NOISE[0,0]`` — already squared —
    as the ``scale`` argument of ``np.random.normal``).  ``variance_as_std``
    reproduces that behaviour for trajectory-level parity; set it False for a
    statistically honest simulation.
    """

    lidar_std: float = 0.15
    position_std: float = 0.5
    orientation_std: float = math.radians(7.1)
    variance_as_std: bool = True

    def lidar_information_diag(self) -> tuple[float, float]:
        v = self.lidar_std**2
        return (1.0 / v, 1.0 / v)

    def odom_information_diag(self) -> tuple[float, float, float]:
        pv = self.position_std**2
        ov = self.orientation_std**2
        return (1.0 / pv, 1.0 / pv, 1.0 / ov)

    def sample_scales(self) -> tuple[float, float, float]:
        """(lidar, position, orientation) scales actually fed to the sampler."""
        if self.variance_as_std:
            return (
                self.lidar_std**2,
                self.position_std**2,
                self.orientation_std**2,
            )
        return (self.lidar_std, self.position_std, self.orientation_std)


@dataclasses.dataclass(frozen=True)
class SimConfig:
    """Scripted robot simulation (reference python/slam_main.py:29,99-123)."""

    robot_steps: int = 150
    start_xy: tuple[float, float] = (5.0, 15.0)
    start_theta: float = 0.0
    seed: int = 0
    lidar: LidarConfig = dataclasses.field(default_factory=LidarConfig)
    noise: NoiseConfig = dataclasses.field(default_factory=NoiseConfig)


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Batch Gauss-Newton with adaptive damping and a Huber robust kernel.

    Semantics mirror the reference Python optimizer
    (python/optimizer/graph_optimizer.py:20-155):

    * ``iterations``/``lr``: slam_main.py:30-31 (10 / 0.2).
    * Huber ``delta`` = 1.5 applied to chi^2: graph_optimizer.py:106-115.
    * adaptive lambda in [1e-6, 1e1], x/÷ 1.1: graph_optimizer.py:24-43.
      (The C++ server path declares but never applies lambda —
      remote/optimizer/OptimizerCpu.h:70; we follow the Python path.)
    * fixed vertices get a 1e6 diagonal prior and a zeroed gradient entry:
      graph_optimizer.py:146-150.
    * convergence when ||lr*dx|| < 0.001 (norm taken *after* the lr scaling,
      graph_optimizer.py:66,90), early stop after ``penalty_limit``
      consecutive error increases (graph_optimizer.py:47-54 — note the
      reference's Python implementation assigns ``prev_err`` before the
      comparison so its penalty branch is dead code; ours compares against
      the previous iteration's error as intended).
    """

    iterations: int = 10
    lr: float = 0.2
    huber_delta: float = 1.5
    lambda_init: float = 1e-3
    lambda_min: float = 1e-6
    lambda_max: float = 1e1
    lambda_factor: float = 1.1
    fixed_prior: float = 1e6
    convergence_eps: float = 1e-3
    penalty_limit: int = 2
    # Odometry-edge Jacobians: the reference approximates A=-I, B=I
    # (python/optimizer/edges2d.py:75-77, remote/graph/edge/EdgeSe2.h:35).
    # ``exact_odom_jacobians=True`` uses the true SE(2) Jacobians instead.
    exact_odom_jacobians: bool = False
    # "dense"      — materialize H, Cholesky/LU solve (small graphs)
    # "schur"      — landmark elimination + PCG on the reduced pose system
    # "schur_grid" — the same math over dual-order grid storage
    #                (ops/grid_schur.py): reductions are dense axis-sums,
    #                chain odometry applies as shifts — the 10k-scale
    #                latency path.  Single-device, chain-only odometry.
    solver: str = "dense"
    # dense linear solve: "cholesky" (fast, H is SPD) or "lu" (reference
    # parity: scipy.linalg.solve, graph_optimizer.py:64)
    dense_factorization: str = "cholesky"
    # PCG controls (schur solver only).  ``pcg_restart_every`` bounds f32
    # recurrence-residual drift via periodic true-residual replacement
    # (ops/schur.py pcg).
    pcg_tol: float = 1e-6
    pcg_max_iters: int = 200
    pcg_restart_every: int = 64
    # PCG preconditioner (ops/schur.py schur_solve):
    #   "jacobi"          — inverse block diagonal of S (local only);
    #   "tridiag"         — exact block-tridiagonal solve (diagonal +
    #                       odometry-chain coupling) via parallel cyclic
    #                       reduction;
    #   "chunk"           — the block-tridiagonal solve restricted to
    #                       ``pcg_chunk``-pose chunks, applied as ONE
    #                       batched matmul (vs the PCR apply's ~log2(N)
    #                       sequential levels of small block ops);
    #   "<local>+coarse"  — two-level: local + additive Galerkin
    #                       coarse-grid correction over groups of
    #                       ``pcg_coarse_group`` poses.  Large graphs need
    #                       the coarse level: smooth error modes otherwise
    #                       dominate (10k-pose: 389 PCG iters with tridiag
    #                       alone).
    pcg_precond: str = "tridiag"
    pcg_coarse_group: int = 64
    # Partitioned (multi-device) solves only: the "+coarse" level is a
    # THREE-level additive scheme there (parallel/partition.py) — the
    # coarse system itself is never solved replicated (a replicated
    # solve would grow with the whole coarse graph on every device).
    # ``pcg_coarse_group2`` = coarse groups per super-group: level 2 is
    # batched dense inverses of super-group diagonal blocks of S_c (zero
    # communication, work O(Nc/D) per device), level 3 a replicated
    # Galerkin solve over the Nc/group2 super-groups (tiny).
    pcg_coarse_group2: int = 4
    pcg_chunk: int = 64
    # How often the PCG preconditioner (tridiag PCR factors + coarse-grid
    # Cholesky) is rebuilt: 1 = every GN iteration (always exact);
    # 0 = built once at the initial state and FROZEN for the whole
    # optimize() call; K>1 = rebuilt every K-th GN iteration.  A
    # preconditioner only needs to *approximate* S, and its build (PCR
    # factorization + coarse inverse) can dominate the solve when PCG
    # converges in a few dozen iterations — freezing trades a few extra
    # PCG iterations for skipping the builds.  Single-device only: the
    # distributed path always rebuilds (a conditional around psum-carrying
    # builds would put collectives under lax.cond, which mis-lowers in
    # shard_map).
    pcg_precond_refresh: int = 1
    # Measurement-harness knob (scripts/bench_scaling_phases.py): run the
    # PCG loop as exactly pcg_max_iters trace-time-unrolled iterations
    # (no while_loop, no early exit) so XLA cost_analysis can count
    # per-iteration work.  Never set for production solves.
    pcg_unroll: bool = False
    # True Levenberg-Marquardt step control: after each solve, evaluate the
    # error at the *updated* state (residuals only — cheap next to the
    # solve); if it increased, revert the step and multiply lambda by
    # ``lambda_reject_factor``.  The reference has no such control (it keeps
    # worsened steps and eventually aborts, graph_optimizer.py:47-54), so
    # this defaults off for parity; the SE(3)/BA path needs it for
    # robustness on loosely-constrained problems.
    reject_worse_steps: bool = False
    lambda_reject_factor: float = 10.0

    def __post_init__(self):
        # A typo'd preconditioner name would otherwise silently degrade to
        # block-Jacobi in build_precond's else branch.
        local, _, coarse = self.pcg_precond.partition("+")
        if local not in ("jacobi", "tridiag", "chunk") or coarse not in (
            "", "coarse"
        ):
            raise ValueError(
                f"pcg_precond={self.pcg_precond!r}: expected "
                "'jacobi'|'tridiag'|'chunk' optionally suffixed '+coarse'"
            )
        if self.solver not in ("dense", "schur", "schur_grid", "schur3d"):
            raise ValueError(f"unknown solver {self.solver!r}")
        if self.pcg_coarse_group2 < 1:
            raise ValueError(
                f"pcg_coarse_group2={self.pcg_coarse_group2}: must be >= 1"
            )


@dataclasses.dataclass(frozen=True)
class SlamConfig:
    sim: SimConfig = dataclasses.field(default_factory=SimConfig)
    optimizer: OptimizerConfig = dataclasses.field(
        default_factory=OptimizerConfig
    )
    # Pad graph arrays up to multiples of these bucket sizes so that growing
    # graphs re-trigger XLA compilation rarely (static shapes requirement).
    pose_bucket: int = 64
    landmark_bucket: int = 64
    edge_bucket: int = 256

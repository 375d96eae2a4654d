"""Damped Gauss-Newton over a :class:`FactorGraph2D`, fully inside ``jit``.

Control flow mirrors the reference Python optimizer
(python/optimizer/graph_optimizer.py:20-92) but runs as a single
``lax.while_loop`` — no per-iteration host round trips:

* adaptive lambda damping, factor 1.1 in [1e-6, 1e1], increased when the
  error grew since the previous iteration (graph_optimizer.py:24-43);
* early stop after ``penalty_limit`` consecutive error increases
  (graph_optimizer.py:47-54; the break fires *before* the state update, as in
  the reference where it precedes the solve);
* convergence when ``||lr * dx|| < eps`` *after* the update
  (graph_optimizer.py:64-92);
* the state update applies to every vertex — fixed vertices are held by the
  1e6 prior, not by skipping their update (graph_optimizer.py:73-77).

The linear solve is pluggable: :func:`dense_linearize_solve` materializes H
via one matmul (ops/assemble.py); the Schur/PCG path for large sparse
graphs lives in ``ops/schur.py`` and plugs in through the same interface.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.models.graph import FactorGraph2D
from toyslam_tpu.ops import assemble, se2

# A linearize-solve computes the (undamped) normal equations at the current
# state, applies `lam` damping, and returns (dx_poses[N,3], dx_lms[M,2],
# err, stats) where dx solves (H + lam I) dx = -b, err is the robust chi^2
# *at the current state* (pre-update, matching calculate_H_b's return
# value), and stats is a schur.SolveStats telemetry record.
LinearizeSolve = Callable[
    [FactorGraph2D, jax.Array],
    tuple[jax.Array, jax.Array, jax.Array, "SolveStats"],
]

from toyslam_tpu.ops.schur import SolveStats  # noqa: E402


class OptimizeResult(NamedTuple):
    graph: FactorGraph2D
    errors: jax.Array        # f32[iterations] robust chi^2 per executed iter (nan-padded)
    iterations_run: jax.Array  # i32[]
    converged: jax.Array       # bool[] stopped via ||dx|| < eps
    diverged: jax.Array        # bool[] stopped via the worsening-error penalty
    # telemetry (the reference prints these; we carry them as data —
    # BlockTimer analogue, reference remote/tools/BlockTimer.cpp:6-19)
    pcg_iters: jax.Array = None       # i32[iterations] PCG iters per GN iter
    pcg_residuals: jax.Array = None   # f32[iterations] final PCG residual
    lambdas: jax.Array = None         # f32[iterations] damping per GN iter


def dense_linearize_solve(cfg: OptimizerConfig) -> LinearizeSolve:
    """Dense H assembly + direct factorization (small/medium graphs)."""

    def solve(graph: FactorGraph2D, lam: jax.Array):
        sys = assemble.assemble_dense(
            graph,
            huber_delta=cfg.huber_delta,
            fixed_prior=cfg.fixed_prior,
            exact_odom_jacobians=cfg.exact_odom_jacobians,
        )
        d = sys.H.shape[0]
        h_reg = sys.H + lam * jnp.eye(d, dtype=sys.H.dtype)
        if cfg.dense_factorization == "cholesky":
            chol = jnp.linalg.cholesky(h_reg)
            dx = jax.scipy.linalg.cho_solve((chol, True), -sys.b)
        else:  # "lu" — parity with scipy.linalg.solve (graph_optimizer.py:64)
            dx = jnp.linalg.solve(h_reg, -sys.b)
        n = graph.num_poses
        dx_p = dx[: 3 * n].reshape(n, 3)
        dx_l = dx[3 * n :].reshape(graph.num_landmarks, 2)
        return dx_p, dx_l, sys.err, SolveStats.direct(sys.H.dtype)

    return solve


class _LoopState(NamedTuple):
    poses: jax.Array
    landmarks: jax.Array
    it: jax.Array
    prev_err: jax.Array
    penalty: jax.Array
    lam: jax.Array
    errors: jax.Array
    converged: jax.Array
    diverged: jax.Array
    pcg_iters: jax.Array
    pcg_residuals: jax.Array
    lambdas: jax.Array
    # opaque solver carry for stateful LinearizeSolves (e.g. the frozen/
    # periodically-refreshed PCG preconditioner, config.pcg_precond_refresh);
    # () for plain solves
    sstate: object = ()


@dataclasses.dataclass(frozen=True)
class GaussNewton:
    """Configured optimizer; ``optimize`` is jit-compiled per graph shape.

    Works on any graph pytree exposing the FactorGraph2D protocol
    (``with_state``, ``poses``, ``landmarks``, ``plan``, edge index arrays);
    ``retract`` maps a pose tangent step onto the pose manifold —
    ``se2.retract`` for 2D (default), ``se3.retract`` for the SE(3)/BA
    graphs (config.solver = "schur3d").  Landmarks update additively in
    both (reference vertices.py:35-46).
    """

    config: OptimizerConfig = OptimizerConfig()
    solve: LinearizeSolve | None = None
    retract: Callable[[jax.Array, jax.Array], jax.Array] | None = None
    # graph -> robust chi^2 at the current state; required only when
    # config.reject_worse_steps (resolved automatically for the builtin
    # solvers).
    error_fn: Callable | None = None

    def __post_init__(self):
        # Build the linearize-solve ONCE: _run's jit cache is keyed on the
        # callable's identity, so a fresh closure per optimize() call would
        # silently recompile every time.
        object.__setattr__(self, "_builtin_solver", self.solve is None)
        if self.solve is None:
            if self.config.solver == "schur":
                from toyslam_tpu.ops.schur import schur_linearize_solve

                solve = schur_linearize_solve(self.config)
            elif self.config.solver == "schur_grid":
                from toyslam_tpu.ops.grid_schur import grid_linearize_solve

                solve = grid_linearize_solve(self.config)
            elif self.config.solver == "schur3d":
                from toyslam_tpu.ops.schur3d import schur3d_linearize_solve

                solve = schur3d_linearize_solve(self.config)
            else:
                solve = dense_linearize_solve(self.config)
            object.__setattr__(self, "solve", solve)
        if self.retract is None:
            if self.config.solver == "schur3d":
                from toyslam_tpu.ops import se3

                object.__setattr__(self, "retract", se3.retract)
            else:
                object.__setattr__(self, "retract", se2.retract)
        if self.config.reject_worse_steps and self.error_fn is None:
            cfg = self.config
            if cfg.solver == "schur3d":
                from toyslam_tpu.ops.schur3d import total_error_3d

                err = functools.partial(
                    total_error_3d,
                    huber_delta=cfg.huber_delta,
                    exact_odom_jacobians=cfg.exact_odom_jacobians,
                )
            else:
                err = functools.partial(
                    assemble.total_error,
                    huber_delta=cfg.huber_delta,
                    exact_odom_jacobians=cfg.exact_odom_jacobians,
                )
            object.__setattr__(self, "error_fn", err)

    def _solver(self) -> LinearizeSolve:
        return self.solve

    def _prepare(self, graph: FactorGraph2D) -> FactorGraph2D:
        # The single-device Schur paths want the scatter-free gather tables
        # (ops/gather_plan.py — structure-generic, works for 2D and 3D
        # graphs); build them host-side once per graph.  A custom solve
        # may expose ``prepare`` for its own layout (e.g. the distributed
        # solve pads edges to the mesh and builds per-shard tables).
        prep = getattr(self.solve, "prepare", None)
        if prep is not None:
            return prep(graph)
        if (
            self._builtin_solver
            and self.config.solver in ("schur", "schur3d")
            and graph.plan is None
        ):
            from toyslam_tpu.ops.gather_plan import attach_plan

            graph = attach_plan(graph)
        return graph

    def optimize(self, graph: FactorGraph2D) -> OptimizeResult:
        return _run(
            self.config, self._solver(), self.retract, self.error_fn,
            self._prepare(graph),
        )

    def step(
        self, graph: FactorGraph2D, lam: jax.Array | float | None = None
    ) -> tuple[FactorGraph2D, jax.Array]:
        """One undamped-control GN step (used by benchmarks / distributed)."""
        cfg = self.config
        lam = jnp.asarray(
            cfg.lambda_init if lam is None else lam, graph.poses.dtype
        )
        solver = self._solver()
        if getattr(solver, "stateful", False):
            # stateful solves (pcg_precond_refresh != 1) carry a
            # preconditioner state; a single step builds and discards one
            dx_p, dx_l, err, _, _ = solver(
                graph, lam, solver.init_state(graph)
            )
        else:
            dx_p, dx_l, err, _ = solver(graph, lam)
        poses = self.retract(graph.poses, dx_p * cfg.lr)
        landmarks = graph.landmarks + dx_l * cfg.lr
        return graph.with_state(poses, landmarks), err


@functools.partial(jax.jit, static_argnums=(0, 1, 2, 3))
def _run(
    cfg: OptimizerConfig,
    solve: LinearizeSolve,
    retract: Callable,
    error_fn: Callable | None,
    graph: FactorGraph2D,
) -> OptimizeResult:
    dtype = graph.poses.dtype
    lam_f = jnp.asarray(cfg.lambda_factor, dtype)

    def cond(s: _LoopState):
        return (s.it < cfg.iterations) & ~s.converged & ~s.diverged

    stateful = getattr(solve, "stateful", False)

    def body(s: _LoopState):
        g = graph.with_state(s.poses, s.landmarks)
        # lambda update decision uses the *previous* iteration's error
        # (graph_optimizer.py:42); first iteration leaves lambda alone only
        # via the prev_err < 0 guard.
        if stateful:
            dx_p, dx_l, err, stats, sstate = solve(g, s.lam, s.sstate)
        else:
            dx_p, dx_l, err, stats = solve(g, s.lam)
            sstate = s.sstate

        step_p = dx_p * cfg.lr
        step_l = dx_l * cfg.lr
        dx_norm = jnp.sqrt(jnp.sum(step_p**2) + jnp.sum(step_l**2))
        errors = s.errors.at[s.it].set(err)
        pcg_iters = s.pcg_iters.at[s.it].set(stats.pcg_iters)
        pcg_residuals = s.pcg_residuals.at[s.it].set(stats.pcg_residual)
        lambdas = s.lambdas.at[s.it].set(s.lam)

        if cfg.reject_worse_steps:
            # True LM trust-region control: evaluate the error *at the
            # updated state* (residuals only — cheap next to the solve) and
            # revert rejected steps with a strong lambda increase.  The
            # reference has no equivalent (it keeps worsened steps).
            new_poses = retract(s.poses, step_p)
            new_landmarks = s.landmarks + step_l
            err_new = error_fn(graph.with_state(new_poses, new_landmarks))
            accept = err_new <= err
            lam = jnp.where(
                accept,
                jnp.maximum(s.lam / lam_f, cfg.lambda_min),
                jnp.minimum(
                    s.lam * cfg.lambda_reject_factor, cfg.lambda_max
                ),
            )
            return _LoopState(
                poses=jnp.where(accept, new_poses, s.poses),
                landmarks=jnp.where(accept, new_landmarks, s.landmarks),
                it=s.it + 1,
                prev_err=jnp.where(accept, err_new, err),
                penalty=jnp.where(accept, 0, s.penalty + 1),
                lam=lam,
                errors=errors,
                converged=accept & (dx_norm < cfg.convergence_eps),
                diverged=jnp.asarray(False),  # lambda control bounds steps
                pcg_iters=pcg_iters,
                pcg_residuals=pcg_residuals,
                lambdas=lambdas,
                sstate=sstate,
            )

        have_prev = s.prev_err >= 0.0
        increased = have_prev & (err > s.prev_err)
        lam = jnp.where(
            increased,
            jnp.minimum(s.lam * lam_f, cfg.lambda_max),
            jnp.maximum(s.lam / lam_f, cfg.lambda_min),
        )
        # NOTE: lambda is updated *after* this iteration's solve; the
        # reference updates lambda before regularizing H in the same
        # iteration (graph_optimizer.py:42-43).  With factor 1.1 the
        # one-iteration phase shift is well inside the ATE bound, and doing
        # it here keeps a single linearize-solve per iteration.
        penalty = jnp.where(increased, s.penalty + 1, 0)
        diverged = penalty > cfg.penalty_limit

        converged = dx_norm < cfg.convergence_eps

        # On a divergence break the reference exits before the solve/update;
        # keep the old state in that case.
        poses = jnp.where(diverged, s.poses, retract(s.poses, step_p))
        landmarks = jnp.where(diverged, s.landmarks, s.landmarks + step_l)

        return _LoopState(
            poses=poses,
            landmarks=landmarks,
            it=s.it + 1,
            prev_err=err,
            penalty=penalty,
            lam=lam,
            errors=errors,
            converged=converged & ~diverged,
            diverged=diverged,
            pcg_iters=pcg_iters,
            pcg_residuals=pcg_residuals,
            lambdas=lambdas,
            sstate=sstate,
        )

    init = _LoopState(
        poses=graph.poses,
        landmarks=graph.landmarks,
        it=jnp.asarray(0, jnp.int32),
        prev_err=jnp.asarray(-1.0, dtype),
        penalty=jnp.asarray(0, jnp.int32),
        lam=jnp.asarray(cfg.lambda_init, dtype),
        errors=jnp.full((cfg.iterations,), jnp.nan, dtype),
        converged=jnp.asarray(False),
        diverged=jnp.asarray(False),
        pcg_iters=jnp.zeros((cfg.iterations,), jnp.int32),
        pcg_residuals=jnp.full((cfg.iterations,), jnp.nan, dtype),
        lambdas=jnp.full((cfg.iterations,), jnp.nan, dtype),
        sstate=solve.init_state(graph) if stateful else (),
    )
    final = jax.lax.while_loop(cond, body, init)
    return OptimizeResult(
        graph=graph.with_state(final.poses, final.landmarks),
        errors=final.errors,
        iterations_run=final.it,
        converged=final.converged,
        diverged=final.diverged,
        pcg_iters=final.pcg_iters,
        pcg_residuals=final.pcg_residuals,
        lambdas=final.lambdas,
    )

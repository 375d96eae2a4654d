"""Command-line application — the reference's slam_main.py re-imagined.

The reference wires its pipeline in a script with module-constant config and
an asyncio render loop (reference python/slam_main.py:26-51,240-274).  Here
the same capability surface is a proper CLI over the typed config
(config.py):

* ``run``   — the 2D LiDAR SLAM pipeline: simulate the scripted trajectory,
  build the factor graph, optimize (locally on the JAX device, or on a
  remote graph server with automatic local fallback, mirroring
  slam_main.py:246-250), report chi2/ATE/timing metrics, optionally render
  or save the GT/dead-reckoning/optimized overlay (the reference's visual
  oracle) and a graph snapshot.
* ``ba3d``  — the SE(3) bundle-adjustment extension on a synthetic problem.
* ``serve`` — stand up a graph-optimization server speaking the framed wire
  codec (Python/JAX in-process, or the C++ native runtime).

Every run prints one JSON metrics line to stdout (machine-readable, like
bench.py); human-oriented progress goes to stderr.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time


def _log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def cmd_live(args, cfg) -> int:
    """Per-frame incremental mode (reference slam_main.py:99-155,240-274):
    step -> scan -> graph insert -> view updates, re-optimizing every
    ``--optimize-every`` frames (0 = only at the end)."""
    import numpy as np

    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.sim import frontend
    from toyslam_tpu.sim.live import LiveSlam, attach_views

    live = LiveSlam(cfg)
    gn = GaussNewton(cfg.optimizer)
    optimize_fn = lambda g: gn.optimize(g).graph  # noqa: E731

    update = None
    view = None
    if args.view or args.save_plot:
        import matplotlib

        if not args.view:
            matplotlib.use("Agg")
        from toyslam_tpu.view.view2d import View

        view = View(title="toyslam_tpu live")
        update = attach_views(live, view)

    t0 = time.perf_counter()
    opt_graph = None
    n_opts = 0
    while live.step():
        if args.optimize_every and live.frame % args.optimize_every == 0:
            opt_graph = live.optimize(optimize_fn)
            n_opts += 1
        if update is not None:
            update(opt_graph)
            if args.view:
                view.pause(0.001)
    opt_graph = live.optimize(optimize_fn)
    n_opts += 1
    if update is not None:
        update(opt_graph)
    wall = time.perf_counter() - t0

    n = len(live.traj_gt)
    gt = np.asarray(live.traj_gt, np.float32)
    est = np.asarray(opt_graph.poses)[:n]
    metrics = {
        "cmd": "run --live",
        "frames": live.frame,
        "optimizations": n_opts,
        "poses": n,
        "landmarks": int(np.asarray(opt_graph.lm_mask).sum()),
        "ate_rmse": round(frontend.ate_rmse(est, gt), 4),
        "ate_dead_reckoning": round(
            frontend.ate_rmse(np.asarray(live.traj_dr, np.float32), gt), 4
        ),
        "wall_s": round(wall, 4),
        "frames_per_s": round(live.frame / wall, 2),
    }
    if args.save_plot and view is not None:
        view.save(args.save_plot)
        metrics["plot"] = args.save_plot
    if view is not None:
        if args.view:
            import matplotlib.pyplot as plt

            plt.show()
        view.close()
    print(json.dumps(metrics))
    return 0


def cmd_run(args) -> int:
    import numpy as np

    from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.sim import frontend

    cfg = SlamConfig(
        sim=SimConfig(robot_steps=args.steps, seed=args.seed),
        optimizer=OptimizerConfig(
            iterations=args.iterations,
            lr=args.lr,
            solver=args.solver,
        ),
    )
    if args.live:
        return cmd_live(args, cfg)
    t0 = time.perf_counter()
    sim = frontend.simulate(cfg.sim)
    t_sim = time.perf_counter() - t0
    graph, _ = frontend.build_graph(sim, cfg)
    t_build = time.perf_counter() - t0 - t_sim

    gn = GaussNewton(cfg.optimizer)
    backend = "local"
    t1 = time.perf_counter()
    if args.remote:
        host, _, port = args.remote.partition(":")
        from toyslam_tpu.io.client import GraphClient, optimize_with_fallback

        client = GraphClient(host or "127.0.0.1", int(port or 8888))

        async def _go():
            try:
                await client.connect()
            except (OSError, asyncio.TimeoutError):
                _log(f"cannot connect to {args.remote}; using local optimizer")
            out, used = await optimize_with_fallback(
                graph, client if client.connected else None,
                lambda g: gn.optimize(g).graph,
            )
            await client.close()
            return out, used

        opt_graph, backend = asyncio.run(_go())
        errors = iters = None
    else:
        if args.profile:
            # jax.profiler trace of the optimize (view with TensorBoard or
            # xprof) — the deep-dive companion of the metrics breakdown
            import jax

            with jax.profiler.trace(args.profile):
                res = gn.optimize(graph)
                np.asarray(res.graph.poses)  # fence inside the trace
        else:
            res = gn.optimize(graph)
        opt_graph = res.graph
        errors = np.asarray(res.errors)
        iters = int(res.iterations_run)
        pcg_iters = np.asarray(res.pcg_iters)[:iters].tolist()
        lambdas = np.asarray(res.lambdas)[:iters].round(6).tolist()
    t_opt = time.perf_counter() - t1

    n = sim.poses_gt.shape[0]
    est = np.asarray(opt_graph.poses)[:n]
    metrics = {
        "cmd": "run",
        "backend": backend,
        "poses": n,
        "landmarks": int(np.asarray(graph.lm_mask).sum()),
        "ate_rmse": round(frontend.ate_rmse(est, sim.poses_gt), 4),
        "ate_dead_reckoning": round(
            frontend.ate_rmse(sim.poses_dr, sim.poses_gt), 4
        ),
        "sim_s": round(t_sim, 4),
        "build_s": round(t_build, 4),
        "optimize_s": round(t_opt, 4),
    }
    if iters is not None:
        metrics["iterations_run"] = iters
        valid = errors[~np.isnan(errors)]
        if valid.size:
            metrics["chi2_first"] = round(float(valid[0]), 2)
            metrics["chi2_final"] = round(float(valid[-1]), 2)
        # solver telemetry (the reference only ever printed these —
        # BlockTimer / per-iter chi2; here they ride the metrics JSON)
        metrics["pcg_iters"] = pcg_iters
        metrics["lambdas"] = lambdas
        if args.profile:
            metrics["profile_trace"] = args.profile

    if args.snapshot:
        from toyslam_tpu.io.snapshot import save_snapshot

        save_snapshot(args.snapshot, opt_graph, metadata={"metrics": metrics})
        metrics["snapshot"] = args.snapshot

    if args.save_plot or args.view:
        import matplotlib

        if not args.view:
            matplotlib.use("Agg")
        from toyslam_tpu.view import render_result

        view = render_result(
            sim.env, sim.radius, sim.poses_gt, sim.poses_dr,
            est,
            np.asarray(opt_graph.landmarks)[
                np.asarray(opt_graph.lm_mask) > 0
            ],
            save_path=args.save_plot,
        )
        if args.save_plot:
            metrics["plot"] = args.save_plot
        if args.view:
            import matplotlib.pyplot as plt

            plt.show()
        view.close()

    print(json.dumps(metrics))
    return 0


def cmd_ba3d(args) -> int:
    import numpy as np

    from toyslam_tpu.config import OptimizerConfig
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.sim import synthetic3d

    graph, poses_gt, _ = synthetic3d.make_ba_problem(
        num_poses=args.poses,
        num_landmarks=args.landmarks,
        obs_per_pose=args.obs,
        seed=args.seed,
    )
    n = poses_gt.shape[0]
    cfg = OptimizerConfig(
        iterations=args.iterations, lr=1.0, solver="schur3d",
        exact_odom_jacobians=True, huber_delta=args.huber,
        pcg_tol=1e-8, pcg_max_iters=400, convergence_eps=1e-8,
        reject_worse_steps=True,
    )
    t0 = time.perf_counter()
    res = GaussNewton(cfg).optimize(graph)
    est = np.asarray(res.graph.poses)
    dt = time.perf_counter() - t0
    errors = np.asarray(res.errors)
    valid = errors[~np.isnan(errors)]
    print(json.dumps({
        "cmd": "ba3d",
        "poses": n,
        "landmarks": int(np.asarray(graph.lm_mask).sum()),
        "reproj_edges": int(np.asarray(graph.lm_edges.mask).sum()),
        "iterations_run": int(res.iterations_run),
        "chi2_first": round(float(valid[0]), 2),
        "chi2_final": round(float(valid[-1]), 2),
        "ate_initial": round(
            synthetic3d.pose_ate_rmse(np.asarray(graph.poses)[:n], poses_gt),
            4,
        ),
        "ate_final": round(synthetic3d.pose_ate_rmse(est[:n], poses_gt), 4),
        "optimize_s": round(dt, 4),
    }))
    return 0


def cmd_serve(args) -> int:
    if args.backend == "native":
        from toyslam_tpu.io.native import NativeServer

        _log(f"native graph server on port {args.port} "
             f"(iterations={args.iterations})")
        with NativeServer(
            port=args.port, iterations=args.iterations
        ) as server:
            _log(f"listening on {server.port}; Ctrl-C to stop")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                return 0
    else:
        from toyslam_tpu.config import OptimizerConfig
        from toyslam_tpu.io.server import PyGraphServer, jax_optimize_fn

        _log(f"JAX graph server on port {args.port}")
        server = PyGraphServer(
            port=args.port,
            optimize_fn=jax_optimize_fn(
                OptimizerConfig(iterations=args.iterations)
            ),
        )
        with server:
            _log(f"listening on {server.port}; Ctrl-C to stop")
            try:
                while True:
                    time.sleep(3600)
            except KeyboardInterrupt:
                return 0
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="toyslam_tpu",
        description="JAX SLAM back end (see README.md)",
    )
    sub = p.add_subparsers(dest="cmd", required=True)

    r = sub.add_parser("run", help="2D LiDAR SLAM pipeline")
    r.add_argument("--steps", type=int, default=150,
                   help="robot steps (reference slam_main.py:29)")
    r.add_argument("--iterations", type=int, default=10)
    r.add_argument("--lr", type=float, default=0.2)
    r.add_argument("--solver", choices=("dense", "schur"), default="schur")
    r.add_argument("--seed", type=int, default=0)
    r.add_argument("--live", action="store_true",
                   help="per-frame incremental mode with live view updates "
                        "(reference slam_main.py:99-155)")
    r.add_argument("--optimize-every", type=int, default=0, metavar="K",
                   help="with --live: re-optimize every K frames "
                        "(0 = only at the end)")
    r.add_argument("--remote", metavar="HOST:PORT", default=None,
                   help="optimize on a graph server (local fallback)")
    r.add_argument("--view", action="store_true",
                   help="show the interactive result plot")
    r.add_argument("--save-plot", metavar="PATH", default=None)
    r.add_argument("--profile", metavar="DIR", default=None,
                   help="write a jax.profiler trace of the optimize to DIR")
    r.add_argument("--snapshot", metavar="PATH", default=None,
                   help="save the optimized graph (wire-codec snapshot)")
    r.set_defaults(fn=cmd_run)

    b = sub.add_parser("ba3d", help="SE(3) bundle adjustment (synthetic)")
    b.add_argument("--poses", type=int, default=64)
    b.add_argument("--landmarks", type=int, default=256)
    b.add_argument("--obs", type=int, default=24)
    b.add_argument("--iterations", type=int, default=25)
    b.add_argument("--huber", type=float, default=1e9)
    b.add_argument("--seed", type=int, default=0)
    b.set_defaults(fn=cmd_ba3d)

    s = sub.add_parser("serve", help="graph-optimization server")
    s.add_argument("--port", type=int, default=8888)
    s.add_argument("--iterations", type=int, default=10)
    s.add_argument("--backend", choices=("jax", "native"), default="jax")
    s.set_defaults(fn=cmd_serve)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    from toyslam_tpu import compile_cache

    compile_cache.enable()
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""Scale results at STATED quality, on a GPU: run the 10k and
100k workloads to a chi^2 plateau, record the convergence curve, the
iterations-to-plateau, and final ATE vs dead-reckoning — not a snapshot at
an arbitrary iteration cap.  Also evaluates chi^2 at the ground-truth
state: on the single-lap serpentine, drift along the sweep is weakly
observable (no loop closures), so GT-chi^2 — not ATE — is the quality
floor there; the laps>=2 configs re-observe the map and gate on ATE.

Writes BENCH_PLATEAU.json.  Exits non-zero without a GPU.
"""

import dataclasses
import json
import os
import time

import _bootstrap  # noqa: F401,E402

import jax
import numpy as np

from toyslam_tpu.config import OptimizerConfig
from toyslam_tpu.ops import assemble
from toyslam_tpu.optimizer import GaussNewton
from toyslam_tpu.sim import frontend, synthetic

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_to_plateau(name, make_graph, opt, n_real, plateau_rtol=1e-3,
                   init=None):
    graph, poses_gt, lms_gt = make_graph()
    ate_dr = frontend.ate_rmse(np.asarray(graph.poses)[:n_real], poses_gt)
    init_extra = {}
    if init is not None:
        t0 = time.time()
        graph = init(graph)
        init_extra = {
            "init_wall_s": round(time.time() - t0, 1),
            "ate_after_init": round(frontend.ate_rmse(
                np.asarray(graph.poses)[:n_real], poses_gt), 4),
        }
    gn = GaussNewton(opt)
    g = jax.device_put(gn._prepare(graph))

    def run(g0):
        rr = jax.block_until_ready(gn.optimize(g0))
        k = int(rr.iterations_run)
        return (rr, k, np.asarray(rr.errors)[:k],
                np.asarray(rr.pcg_iters)[:k])

    t0 = time.time()
    r, iters, errs, pcg_iters = run(g)
    wall0 = time.time() - t0
    t0 = time.time()
    r, iters, errs, pcg_iters = run(g)
    wall = time.time() - t0
    est = np.asarray(r.graph.poses)

    valid = errs[~np.isnan(errs)]
    # iterations to plateau: first iteration whose chi^2 is within
    # plateau_rtol of the final value
    final = float(valid[-1])
    reach = int(np.argmax(valid <= final * (1.0 + plateau_rtol))) + 1

    # chi^2 at ground truth (the quality floor for drift-limited configs);
    # real entries overwrite the padded arrays, padding stays masked
    pp = np.array(graph.poses)
    pp[:n_real] = np.asarray(poses_gt, np.float32)
    ll = np.array(graph.landmarks)
    ll[:len(lms_gt)] = np.asarray(lms_gt, np.float32)
    gt_state = graph.with_state(pp, ll)
    chi2_gt = float(assemble.total_error(
        jax.device_put(gt_state), huber_delta=opt.huber_delta,
        exact_odom_jacobians=opt.exact_odom_jacobians,
    ))

    out = {
        "config": name,
        "poses": n_real,
        "landmarks": int(np.asarray(graph.lm_mask).sum()),
        "lm_edges": int(np.asarray(graph.lm_edges.mask).sum()),
        "iterations_run": iters,
        "iters_per_s": round(iters / wall, 2),
        "wall_s": round(wall, 2),
        "wall_first_incl_compile_s": round(wall0, 1),
        "converged": bool(r.converged),
        "iters_to_plateau": reach,
        # wall-clock to the plateau under THIS config's budget: the
        # headline iters/s and iters_to_plateau come from the same run,
        # so their ratio is the time-to-quality here
        "wall_to_plateau_s": round(reach * wall / iters, 2),
        "chi2_curve": [round(float(v), 1) for v in valid],
        "chi2_final": round(final, 1),
        "chi2_at_ground_truth": round(chi2_gt, 1),
        "ate_rmse": round(frontend.ate_rmse(est[:n_real], poses_gt), 4),
        "ate_dead_reckoning": round(ate_dr, 4),
        "pcg_iters": pcg_iters.tolist(),
        **init_extra,
    }
    print(json.dumps(out), flush=True)
    return out


def main():
    import sys

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_plateau: no GPU (JAX found {dev.platform!r})")
    only = sys.argv[1] if len(sys.argv) > 1 else None
    results = []
    if only == "100k":
        results.extend(run_100k())
        _write(results, merge=True)
        return
    if only == "10k":
        results.extend(run_10k())
        _write(results, merge=True)
        return
    if only == "incr":
        results.append(run_100k_incr())
        _write(results, merge=True)
        return
    results.extend(run_10k())
    results.extend(run_100k())
    _write(results)


def run_10k():
    base = OptimizerConfig(
        iterations=60, lr=1.0, solver="schur_grid",
        exact_odom_jacobians=True,
        pcg_tol=1e-3, pcg_max_iters=60, pcg_restart_every=30,
        pcg_precond="tridiag+coarse", pcg_coarse_group=32,
        pcg_precond_refresh=5, convergence_eps=1e-4,
    )
    out = []

    # 10k single lap: drift-limited (no closures) — gate = GT-chi^2
    out.append(run_to_plateau(
        "plateau-10k",
        lambda: synthetic.make_large_problem(
            num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0,
        ),
        base, 10_000,
    ))

    # 10k with revisits: ATE observable
    out.append(run_to_plateau(
        "plateau-10k-revisit",
        lambda: synthetic.make_large_problem(
            num_poses=10_000, num_landmarks=5_000, obs_per_pose=6, seed=0,
            laps=2,
        ),
        base, 10_000,
    ))
    return out


def run_100k():
    # 100k with revisits (laps=2), TWO noise regimes:
    #
    # * default sensor noise — compounding odometry error puts the
    #   dead-reckoning initial guess at ATE ~1028 on a ~630-unit arena:
    #   rotational errors are O(pi) and the linearization point is outside
    #   the Gauss-Newton basin, so the optimizer reaches a local minimum
    #   (chi^2 5.3e9 -> ~5e6 over 40 iterations, still ~60x the GT chi^2
    #   of 7.8e4).  This is an INITIALIZATION limit, not a solver-speed
    #   limit — real systems initialize incrementally; recorded as the
    #   honest capacity/convergence-curve result.
    # * low noise (position_std 0.05, orientation 0.2 deg) — the DR init
    #   stays inside the basin and the same solver recovers the
    #   trajectory: the full-recovery gate at 100k.
    from toyslam_tpu.config import NoiseConfig

    base = OptimizerConfig(
        iterations=40, lr=1.0, solver="schur_grid",
        exact_odom_jacobians=True,
        pcg_tol=1e-3, pcg_max_iters=60, pcg_restart_every=30,
        pcg_precond="tridiag+coarse", pcg_coarse_group=64,
        pcg_precond_refresh=5, convergence_eps=1e-4,
    )
    out = [run_to_plateau(
        "plateau-100k-revisit",
        lambda: synthetic.make_large_problem(
            num_poses=100_000, num_landmarks=50_000, obs_per_pose=6,
            seed=0, laps=2,
            pose_bucket=1024, landmark_bucket=1024, edge_bucket=8192,
        ),
        base, 100_000,
    )]
    out.append(run_100k_incr())
    import math

    low = NoiseConfig(position_std=0.05,
                      orientation_std=math.radians(0.2))
    out.append(run_to_plateau(
        "plateau-100k-revisit-lownoise",
        lambda: synthetic.make_large_problem(
            num_poses=100_000, num_landmarks=50_000, obs_per_pose=6,
            seed=0, laps=2, noise=low,
            pose_bucket=1024, landmark_bucket=1024, edge_bucket=8192,
        ),
        base, 100_000,
    ))
    return out


def run_100k_incr():
    # default noise WITH incremental initialization:
    # sequential prefix-window optimization keeps every solve one window
    # of drift from its solution (optimizer/coarse_init.py) — ~1 rad of
    # in-window rotation drift at window=4096 under the default sampled
    # noise (0.124^2 rad/step via the variance-as-std quirk) — and
    # re-initializes each window's fresh landmarks from their first
    # observation through the re-based pose, putting the full problem
    # inside the basin that raw dead reckoning leaves at this scale.
    # 80 iterations: the post-init solve keeps descending past 40.
    from toyslam_tpu.optimizer.coarse_init import incremental_init

    base = OptimizerConfig(
        iterations=80, lr=1.0, solver="schur_grid",
        exact_odom_jacobians=True,
        pcg_tol=1e-3, pcg_max_iters=60, pcg_restart_every=30,
        pcg_precond="tridiag+coarse", pcg_coarse_group=64,
        pcg_precond_refresh=5, convergence_eps=1e-4,
    )

    def _init(g):
        return incremental_init(
            g, window=4096, iters_per_prefix=5,
            solver_cfg=dataclasses.replace(
                base, pcg_max_iters=30, pcg_restart_every=30,
                pcg_precond_refresh=0,
            ),
        )

    return run_to_plateau(
        "plateau-100k-revisit-incr-init",
        lambda: synthetic.make_large_problem(
            num_poses=100_000, num_landmarks=50_000, obs_per_pose=6,
            seed=0, laps=2,
            pose_bucket=1024, landmark_bucket=1024, edge_bucket=8192,
        ),
        base, 100_000,
        init=_init,
    )


def _write(results, merge=False):
    path = os.path.join(REPO, "BENCH_PLATEAU.json")
    if merge and os.path.exists(path):
        old = json.load(open(path))["configs"]
        keep = [c for c in old
                if c["config"] not in {r["config"] for r in results}]
        results = keep + results
    with open(path, "w") as f:
        json.dump({
            "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "note": (
                "runs to a chi^2 plateau (iters_to_plateau = first "
                "iteration within 0.1% of final); single-lap configs are "
                "drift-limited so chi2_at_ground_truth is the quality "
                "floor, revisit configs gate on ATE"
            ),
            "configs": results,
        }, f, indent=2)
    print(f"wrote {path}")


if __name__ == "__main__":
    main()

"""Full benchmark suite over BASELINE.json's workload configs, on a GPU.

Prints one JSON line per config and, with ``--out PATH``, writes the
combined matrix there.  bench.py remains the single-line headline
benchmark; this suite covers the scale-up matrix:

  0. reference workload  — 150 poses   (parity vs BASELINE_MEASURED.json)
  1. multi-loop closures — ~1k poses
  2. large sparse        — ~10k poses / ~10k landmarks (Schur + PCG with a
     truncated-Newton budget), and its 2-lap revisit variant
  3. SE(3) bundle adjustment — 128 cameras x 512 points

Timing: ``reps`` optimizes back to back, fenced by
``jax.block_until_ready``; the median of ``rounds`` is the headline and
every round is recorded.  For the large config the output also carries a
FLOP and byte model of one GN iteration and the achieved rates (no peak
fractions: no peak table for the GPU is kept yet).  Exits non-zero without
a GPU.
"""

import argparse
import dataclasses
import json
import statistics
import sys
import time

import _bootstrap  # noqa: F401,E402  (source-checkout shim)

import jax
import numpy as np

from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
from toyslam_tpu.optimizer import GaussNewton
from toyslam_tpu.sim import frontend, synthetic

def _time_rounds(gn, g, reps, rounds):
    """Median-of-rounds timing; returns (last result, per-call times)."""
    times = []
    r = None
    for _ in range(rounds):
        t0 = time.perf_counter()
        for _ in range(reps):
            r = gn.optimize(g)
        jax.block_until_ready(r)
        times.append((time.perf_counter() - t0) / reps)
    return r, times


def bench_one(name, graph, gt, opt_cfg, n_real, reps=5, rounds=3,
              flops_per_iter=None, bytes_per_iter=None):
    gn = GaussNewton(opt_cfg)
    g = jax.device_put(gn._prepare(graph))
    iters = int(jax.block_until_ready(gn.optimize(g)).iterations_run)
    r, times = _time_rounds(gn, g, reps, rounds)
    est = np.asarray(r.graph.poses)[:n_real]
    med = statistics.median(times)
    errs = np.asarray(r.errors)
    valid = errs[~np.isnan(errs)]
    out = {
        "config": name,
        "poses": n_real,
        "landmarks": int(np.asarray(graph.lm_mask).sum()),
        "lm_edges": int(np.asarray(graph.lm_edges.mask).sum()),
        "iters_per_s": iters / med,
        "iters_per_s_best": iters / min(times),
        "headline_stat": "median of rounds",
        "iters_run": iters,
        "wall_s": med,
        "wall_s_rounds": times,
        "ate_rmse": frontend.ate_rmse(est, gt),
        "ate_dead_reckoning": frontend.ate_rmse(
            np.asarray(graph.poses)[:n_real], gt
        ),
        "chi2_first": float(valid[0]) if valid.size else None,
        "chi2_last": float(valid[-1]) if valid.size else None,
        "pcg_iters": np.asarray(r.pcg_iters)[:iters].tolist(),
    }
    t_iter = med / iters
    if flops_per_iter:
        out["flops_per_gn_iter_model"] = int(flops_per_iter)
        out["achieved_gflops"] = flops_per_iter / t_iter / 1e9
    if bytes_per_iter:
        out["bytes_per_gn_iter_model"] = int(bytes_per_iter)
        out["achieved_gbps"] = bytes_per_iter / t_iter / 1e9
    print(json.dumps(out), flush=True)
    return out


def _flop_byte_model_10k(n, m, e1, e2, pcg_iters, levels=14, nc=320):
    """Rough per-GN-iteration FLOP / device-byte model for the Schur path.

    FLOPs: linearization ~350/edge; per PCG iteration the plan matvec
    (~48 flops per lm edge twice + block diagonals), the PCR tridiag apply
    (levels x 2 block-matvecs over N), the coarse solve (2 (3 nc)^2) and
    ~6 axpy/dot passes.  Bytes: every PCG iteration re-reads the dual-layout
    grids (~4.5 MB), the PCR factors (2 levels x N x 9 f32) and the coarse
    factor.
    """
    lin = 350 * (e1 + e2)
    matvec = 48 * 2 * e2 + 8 * m + 18 * n + 36 * e1
    tri = levels * 40 * n
    coarse = 2 * (3 * nc) ** 2
    axpy = 8 * 3 * n
    flops = lin + pcg_iters * (matvec + tri + coarse + axpy)

    grids = (e2 * 6 * 2 + n * 9 + m * 4 + e1 * 9 * 2) * 4
    pcr = (2 * levels + 1) * n * 9 * 4
    coarse_b = (3 * nc) ** 2 * 4
    state = 6 * n * 3 * 4
    bytes_ = (e1 + e2) * 30 * 4 + pcg_iters * (
        grids + pcr + coarse_b + state
    )
    return flops, bytes_


def bench_ba3d(reps=5, rounds=3, num_poses=128, num_landmarks=512,
               matched_budget=False):
    """SE(3)/BA.  ``matched_budget=True`` pins the PCG budget (tol 0,
    cap 64) so the time per GN iteration does not depend on the
    convergence policy."""
    from toyslam_tpu.ops import residuals3d
    from toyslam_tpu.sim import synthetic3d

    graph, poses_gt, _ = synthetic3d.make_ba_problem(
        num_poses=num_poses, num_landmarks=num_landmarks,
        obs_per_pose=24, seed=0,
    )
    n = poses_gt.shape[0]

    def reproj_rmse(g):
        ev = residuals3d.eval_reproj_edges(
            g.poses, g.landmarks, g.intrinsics, g.lm_edges.pose,
            g.lm_edges.lm, g.lm_edges.meas, g.lm_edges.info,
            g.lm_edges.mask, huber_delta=1e9,
        )
        r2 = np.sum(np.asarray(ev.r) ** 2, axis=-1)
        msk = np.asarray(g.lm_edges.mask) > 0
        return float(np.sqrt(r2[msk].mean()))

    if matched_budget:
        cfg = OptimizerConfig(
            iterations=20, lr=1.0, solver="schur3d",
            exact_odom_jacobians=True, huber_delta=4.0,
            pcg_tol=0.0, pcg_max_iters=64, pcg_restart_every=64,
            convergence_eps=1e-8, reject_worse_steps=True,
            pcg_precond="tridiag",
        )
    else:
        cfg = OptimizerConfig(
            iterations=20, lr=1.0, solver="schur3d",
            exact_odom_jacobians=True, huber_delta=4.0,
            pcg_tol=1e-6, pcg_max_iters=200, convergence_eps=1e-8,
            reject_worse_steps=True, pcg_precond="tridiag",
        )
    gn = GaussNewton(cfg)
    g = jax.device_put(gn._prepare(graph))
    iters = int(jax.block_until_ready(gn.optimize(g)).iterations_run)
    r, times = _time_rounds(gn, g, reps, rounds)
    med = statistics.median(times)
    est = np.asarray(r.graph.poses)[:n]
    errs = np.asarray(r.errors)
    valid = errs[~np.isnan(errs)]
    rec = {
        "config": (
            f"ba3d-{num_poses}x{num_landmarks}"
            + ("-matched64" if matched_budget else "")
        ),
        "poses": n,
        "landmarks": int(np.asarray(graph.lm_mask).sum()),
        "lm_edges": int(np.asarray(graph.lm_edges.mask).sum()),
        "iters_per_s": iters / med,
        "iters_per_s_best": iters / min(times),
        "headline_stat": "median of rounds",
        "iters_run": iters,
        "wall_s": med,
        "wall_s_rounds": times,
        "ate_rmse": synthetic3d.pose_ate_rmse(est, poses_gt),
        "ate_initial": synthetic3d.pose_ate_rmse(
            np.asarray(graph.poses)[:n], poses_gt),
        "reproj_rmse_px": reproj_rmse(r.graph),
        "chi2_first": float(valid[0]) if valid.size else None,
        "chi2_last": float(valid[-1]) if valid.size else None,
        "pcg_iters": np.asarray(r.pcg_iters)[:iters].tolist(),
    }
    print(json.dumps(rec), flush=True)
    return rec


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None,
                    help="also write the combined matrix to this JSON file")
    args = ap.parse_args()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        sys.exit(f"bench_suite: no GPU (JAX found {dev.platform!r})")
    results = []

    # 0. reference workload (parity config: reference-equivalent settings)
    cfg = SlamConfig(sim=SimConfig(robot_steps=150, seed=0))
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    results.append(bench_one(
        "reference-150",
        graph,
        sim.poses_gt,
        OptimizerConfig(iterations=10, lr=0.2, solver="schur"),
        150,
        reps=20,
    ))

    # 1. multi-loop ~1k poses with loop closures
    cfg = SlamConfig(sim=SimConfig(robot_steps=1050, seed=0))
    controls = synthetic.multi_loop_controls(1049, loop_steps=150)
    sim = frontend.simulate(cfg.sim, controls=controls)
    graph, _ = frontend.build_graph(sim, cfg)
    results.append(bench_one(
        "multi-loop-1k",
        graph,
        sim.poses_gt,
        OptimizerConfig(
            iterations=15, lr=0.5, solver="schur",
            exact_odom_jacobians=True, pcg_max_iters=300,
        ),
        1050,
        reps=10,
    ))

    # 2. large sparse ~10k x ~10k — truncated-Newton budget (15 PCG
    # iterations, preconditioner refreshed every 5 GN iterations); the
    # workload is drift-limited, so chi2 against chi2(ground truth) is the
    # quality gate, not ATE (chip_smoke.py's large10k phase checks it).
    graph, poses_gt, _ = synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0,
    )
    # solver="schur_grid": dual-order grid storage (ops/grid_schur.py)
    opt = OptimizerConfig(
        iterations=15, lr=1.0, solver="schur_grid",
        exact_odom_jacobians=True, pcg_tol=1e-2,
        pcg_max_iters=15, pcg_restart_every=15,
        pcg_precond="tridiag+coarse", pcg_coarse_group=32,
        pcg_precond_refresh=5,
    )
    n, m = graph.num_poses, graph.num_landmarks
    flops, bytes_ = _flop_byte_model_10k(
        n, m, graph.odom.count, graph.lm_edges.count,
        pcg_iters=opt.pcg_max_iters, nc=n // opt.pcg_coarse_group,
    )
    results.append(bench_one(
        "large-sparse-10k",
        graph,
        poses_gt,
        opt,
        10_000,
        reps=3,
        flops_per_iter=flops,
        bytes_per_iter=bytes_,
    ))

    # 3. large sparse 10k with REVISITS (laps=2): every lap re-observes the
    # map, so ATE is observable — the trajectory-recovery gate the
    # no-loop-closure workload above cannot provide.
    graph, poses_gt, _ = synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=5_000, obs_per_pose=6, seed=0,
        laps=2,
    )
    results.append(bench_one(
        "large-sparse-10k-revisit",
        graph,
        poses_gt,
        dataclasses.replace(opt, iterations=20),
        poses_gt.shape[0],
        reps=3,
    ))

    # 4. SE(3)/BA — BASELINE configs[3], the reference's "further
    # development" roadmap (reference README.md:52-56).  Records
    # reprojection RMSE + translation ATE + iter/s.
    results.append(bench_ba3d())
    # matched PCG budget: time per GN iteration independent of exit policy
    results.append(bench_ba3d(matched_budget=True))

    if args.out:
        with open(args.out, "w") as f:
            json.dump({
                "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
                "device": {"platform": dev.platform, "kind": dev.device_kind,
                           "count": len(jax.devices())},
                "note": "block_until_ready-fenced timing; "
                        "median-of-rounds headline, all rounds recorded",
                "configs": results,
            }, f, indent=2)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()

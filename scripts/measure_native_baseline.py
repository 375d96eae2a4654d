"""Measure the strongest CPU comparator: the native C++ Gauss-Newton engine
(native/src/optimizer.cpp — an Eigen-class dense GN with lambda damping and a
thread-pooled assembly) on the exact 150-pose headline graph.

BASELINE.json's target is ">=10x the reference Eigen CPU solver path"
(reference remote/optimizer/OptimizerCpu.h:25-183 + SolverEigen.h:11-21).
Round 1 compared only against the reference *Python* optimizer (0.69 iter/s)
— the weakest comparator.  The reference server itself cannot be built here
(boost/conan deps, CUDA toolchain), but our own native engine implements the
same dense-GN-with-direct-solve algorithm in optimized C++ (double-precision
Cholesky, pooled assembly), so it is the honest stand-in.  Results are merged
into BASELINE_MEASURED.json under "native_cpu".
"""

import json
import os
import sys
import time

# before _bootstrap, which imports jax (jax reads JAX_PLATFORMS at import)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import _bootstrap  # noqa: F401,E402  (source-checkout shim)

import numpy as np

from toyslam_tpu.config import SlamConfig, SimConfig, OptimizerConfig
from toyslam_tpu.io import native
from toyslam_tpu.sim import frontend


def main():
    cfg = SlamConfig(
        sim=SimConfig(robot_steps=150, seed=0),
        optimizer=OptimizerConfig(iterations=10, lr=0.2),
    )
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    gt = np.asarray(sim.poses_gt)

    results = {}
    for threads in (1, 0):  # 0 = hardware_concurrency
        label = "1 thread" if threads == 1 else "all threads"
        # warmup
        g_opt, stats = native.native_optimize(graph, num_threads=threads)
        best = float("inf")
        for _ in range(5):
            t0 = time.perf_counter()
            g_opt, stats = native.native_optimize(graph, num_threads=threads)
            best = min(best, time.perf_counter() - t0)
        iters = int(stats.iterations_run)
        est = np.asarray(g_opt.poses)[: gt.shape[0]]
        results[label] = {
            "wall_s": round(best, 4),
            "iters_per_s": round(iters / best, 2),
            "iterations_run": iters,
            "final_ate_rmse": round(frontend.ate_rmse(est, gt), 4),
        }
        print(label, json.dumps(results[label]))

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "..",
        "BASELINE_MEASURED.json",
    )
    with open(path) as f:
        data = json.load(f)
    best_label = max(results, key=lambda k: results[k]["iters_per_s"])
    data["native_cpu"] = {
        "pipeline": "toyslam_tpu native C++ engine (dense GN, double "
                    "Cholesky, pooled assembly) — Eigen-class CPU "
                    "comparator standing in for the reference server "
                    "(remote/optimizer/OptimizerCpu.h), which needs "
                    "boost/conan/CUDA unavailable here",
        "host_cpus": os.cpu_count(),
        **{k.replace(" ", "_"): v for k, v in results.items()},
        "iters_per_s": results[best_label]["iters_per_s"],
        "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    with open(path, "w") as f:
        json.dump(data, f, indent=2)
    print("updated BASELINE_MEASURED.json: native_cpu.iters_per_s =",
          data["native_cpu"]["iters_per_s"])


if __name__ == "__main__":
    main()

"""Cost of one PCG iteration of the XLA solve on the current device.

For each cell — the 150-pose reference graph on ``schur`` and the 10k x 10k
synthetic graph on ``schur_grid`` — one jitted linearize+solve runs at two
fixed PCG budgets ``K1 < K2`` (tol 0, one restart chunk, so exactly k
iterations run).  Differencing the two removes everything outside the loop:

* ``ms_per_pcg_iter``   = (t(k2) - t(k1)) / (k2 - k1), host clock around
  ``block_until_ready``, median of ``REPS`` calls each;
* ``kernels_per_pcg_iter`` = difference of the device-kernel event counts
  in a ``jax.profiler`` trace of one call each;
* ``busy_ms_per_pcg_iter`` = difference of the union of those kernels'
  device intervals.

Prints one JSON line per cell (and appends it to ``--out``), with the
device it ran on and the per-line event counts of the trace it read.

    python scripts/profile_step.py [--out FILE]
"""

import argparse
import dataclasses
import glob
import json
import os
import statistics
import tempfile
import time

import _bootstrap  # noqa: F401  (source-checkout shim)

import jax
import jax.numpy as jnp
import numpy as np

from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
from toyslam_tpu.ops import grid_schur, schur
from toyslam_tpu.ops.gather_plan import attach_plan
from toyslam_tpu.sim import frontend, synthetic

CELLS = ("150", "10k")
K1, K2 = 10, 40  # PCG budgets whose difference is timed
REPS = 20  # timed calls per budget


def _cell(name):
    """(solve factory, prepared graph, base config) for a cell."""
    if name == "150":
        sc = SlamConfig(sim=SimConfig(robot_steps=150, seed=0))
        graph, _ = frontend.build_graph(frontend.simulate(sc.sim), sc)
        cfg = OptimizerConfig(solver="schur", pcg_precond="tridiag")
        return schur.schur_linearize_solve, attach_plan(graph), cfg
    graph, _, _ = synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0,
    )
    cfg = OptimizerConfig(
        solver="schur_grid", exact_odom_jacobians=True,
        pcg_precond="tridiag+coarse", pcg_coarse_group=32,
    )
    make = grid_schur.grid_linearize_solve
    return make, make(cfg).prepare(graph), cfg


def trace_kernels(xplane_path):
    """Device-kernel count and busy time (union of intervals, ns) from one
    trace, plus the per-line event counts of every device plane."""
    from jax.profiler import ProfileData

    pd = ProfileData.from_file(xplane_path)
    lines = {}
    intervals = []
    for plane in pd.planes:
        if not plane.name.startswith("/device:"):
            continue
        for line in plane.lines:
            evs = list(line.events)
            lines[f"{plane.name}|{line.name}"] = len(evs)
            if "Stream" in line.name:
                intervals += [(e.start_ns, e.end_ns) for e in evs]
    intervals.sort()
    busy, end = 0.0, -np.inf
    for s, e in intervals:
        if e > end:
            busy += e - max(s, end)
            end = e
    return len(intervals), busy, lines


def _one_budget(make, graph, cfg, k, tmp):
    c = dataclasses.replace(cfg, pcg_tol=0.0, pcg_max_iters=k,
                            pcg_restart_every=k)
    f = jax.jit(make(c))
    lam = jnp.asarray(1e-3, jnp.float32)
    jax.block_until_ready(f(graph, lam))
    times = []
    for _ in range(REPS):
        t0 = time.perf_counter()
        jax.block_until_ready(f(graph, lam))
        times.append(time.perf_counter() - t0)
    tdir = os.path.join(tmp, f"k{k}")
    with jax.profiler.trace(tdir):
        jax.block_until_ready(f(graph, lam))
    path = glob.glob(os.path.join(tdir, "plugins/profile/*/*.xplane.pb"))[0]
    n, busy, lines = trace_kernels(path)
    return statistics.median(times), n, busy, lines


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    dev = jax.devices()[0]
    for name in CELLS:
        make, graph, cfg = _cell(name)
        graph = jax.device_put(graph)
        with tempfile.TemporaryDirectory() as tmp:
            t1, n1, b1, _ = _one_budget(make, graph, cfg, K1, tmp)
            t2, n2, b2, lines = _one_budget(make, graph, cfg, K2, tmp)
        dk = K2 - K1
        rec = {
            "cell": name, "solver": cfg.solver, "precond": cfg.pcg_precond,
            "poses": graph.num_poses, "landmarks": graph.num_landmarks,
            "k1": K1, "k2": K2,
            "solve_ms": {str(K1): t1 * 1e3, str(K2): t2 * 1e3},
            "ms_per_pcg_iter": (t2 - t1) / dk * 1e3,
            "kernels": {str(K1): n1, str(K2): n2},
            "kernels_per_pcg_iter": (n2 - n1) / dk,
            "busy_ms_per_pcg_iter": (b2 - b1) / dk / 1e6,
            "trace_lines_k2": lines,
            "device": {"platform": dev.platform, "kind": dev.device_kind,
                       "count": len(jax.devices())},
        }
        line = json.dumps(rec)
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")


if __name__ == "__main__":
    main()

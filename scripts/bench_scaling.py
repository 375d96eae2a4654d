"""Strong-scaling harness for the distributed collective-Schur solve.

Measures wall time of the identical edge-sharded Gauss-Newton workload at
1..N devices and reports scaling efficiency  eff(D) = T(1) / (D * T(D)).

On this container only a virtual CPU mesh is available
(``--xla_force_host_platform_device_count``), where every "device" is a
thread on two shared host cores, so wall time measures TOTAL work summed
over fake devices: the sharded linearization stays constant as D grows
(work/device shrinks 1/D) while the replicated part (PCG state updates +
preconditioner apply, by design identical on every device — free on real
parallel chips) multiplies by D.  The fake-mesh curve therefore bounds the
replicated fraction and validates the collective schedule end-to-end; true
efficiency targets (>=0.8 at 2+ hosts, BASELINE.json) need real chips, and
this rig — unchanged — is what measures them there.  Writes
``SCALING.json``.

Usage:
  python scripts/bench_scaling.py                 # fake mesh, 1/2/4/8
  TOYSLAM_REAL_DEVICES=1 python scripts/bench_scaling.py   # real platform
"""

import argparse
import json
import os
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
import _bootstrap  # noqa: F401,E402  (source-checkout shim)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--poses", type=int, default=2000)
    ap.add_argument("--landmarks", type=int, default=2000)
    ap.add_argument("--obs", type=int, default=6)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--out", default=os.path.join(REPO, "SCALING.json"))
    args = ap.parse_args()

    if not os.environ.get("TOYSLAM_REAL_DEVICES"):
        os.environ["JAX_PLATFORMS"] = "cpu"
        flags = os.environ.get("XLA_FLAGS", "")
        os.environ["XLA_FLAGS"] = (
            flags
            + f" --xla_force_host_platform_device_count={max(args.devices)}"
        )

    import jax

    if not os.environ.get("TOYSLAM_REAL_DEVICES"):
        # _bootstrap has already imported jax, which read JAX_PLATFORMS at
        # import; the config update (before the backend starts) pins CPU
        jax.config.update("jax_platforms", "cpu")
    import numpy as np

    from toyslam_tpu.config import OptimizerConfig
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.parallel import distributed_linearize_solve
    from toyslam_tpu.parallel.mesh import make_mesh
    from toyslam_tpu.sim import synthetic

    graph, poses_gt, _ = synthetic.make_large_problem(
        num_poses=args.poses, num_landmarks=args.landmarks,
        obs_per_pose=args.obs, seed=0,
    )
    cfg = OptimizerConfig(
        iterations=args.iterations, lr=1.0, solver="schur",
        exact_odom_jacobians=True, pcg_tol=1e-2,
        pcg_max_iters=25, pcg_restart_every=25,
        pcg_precond="tridiag+coarse",
        pcg_coarse_group=max(8, args.poses // 320),
    )

    rows = []
    for d in args.devices:
        if d > jax.device_count():
            print(f"skip D={d}: only {jax.device_count()} devices")
            continue
        mesh = make_mesh(d)
        gn = GaussNewton(cfg, solve=distributed_linearize_solve(cfg, mesh))
        g = gn._prepare(graph)
        r = gn.optimize(g)
        np.asarray(r.graph.poses)  # fence
        best = float("inf")
        for _ in range(args.reps):
            t0 = time.perf_counter()
            r = gn.optimize(g)
            np.asarray(r.graph.poses)
            best = min(best, time.perf_counter() - t0)
        iters = int(r.iterations_run)
        rows.append({
            "devices": d,
            "wall_s": round(best, 4),
            "gn_iters_per_s": round(iters / best, 2),
        })
        print(json.dumps(rows[-1]), flush=True)

    t1 = rows[0]["wall_s"] if rows else None
    for row in rows:
        row["speedup"] = round(t1 / row["wall_s"], 3)
        row["efficiency"] = round(t1 / (row["devices"] * row["wall_s"]), 3)

    artifact = {
        "workload": f"large-sparse {args.poses}x{args.landmarks}, "
                    f"{args.iterations} GN iters, edge-sharded "
                    "collective-Schur",
        "platform": jax.devices()[0].platform,
        "real_devices": bool(os.environ.get("TOYSLAM_REAL_DEVICES")),
        "note": (
            "virtual CPU mesh on shared host cores: wall = TOTAL work over "
            "fake devices (sharded part constant, replicated PCG/precond "
            "part x D — free on real parallel chips), so the growth bounds "
            "the replicated fraction and validates the collective schedule; "
            "real-chip efficiency needs a real slice (same rig)"
            if not os.environ.get("TOYSLAM_REAL_DEVICES")
            else "real devices"
        ),
        "rows": rows,
        "measured_at": time.strftime("%Y-%m-%d %H:%M:%S"),
    }
    with open(args.out, "w") as f:
        json.dump(artifact, f, indent=2)
    print("wrote", args.out)


if __name__ == "__main__":
    main()

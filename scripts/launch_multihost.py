"""Multi-process (multi-host) distributed BA: launcher + worker + artifact.

The reference's only cross-process story is one TCP socket per graph
(reference remote/conn/ConnectionManagerServer.h:22-61).  Here N worker
processes join a jax.distributed runtime (Gloo on CPU), build the same deterministic problem, shard
the edges over the global host mesh, and run the collective-Schur
Gauss-Newton — every reduction is an XLA collective, no sockets in the hot
path.

Usage:
  python scripts/launch_multihost.py                # 2 procs x 4 devices
  python scripts/launch_multihost.py --procs 4 --devices-per-proc 2
  python scripts/launch_multihost.py --steps 300 --out MULTIHOST.json

The launcher spawns workers on localhost, collects proc 0's metrics JSON,
checks every process agreed bitwise on the replicated result, and writes
the artifact.
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args) -> None:
    # env is prepared by the launcher BEFORE jax import
    import jax

    jax.config.update("jax_platforms", "cpu")
    import _bootstrap  # noqa: F401,E402  (source-checkout shim)

    import numpy as np

    from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.parallel import (
        distributed_linearize_solve, initialize_distributed,
        make_host_mesh, shard_graph,
    )
    from toyslam_tpu.sim import frontend

    assert initialize_distributed(), "worker needs TOYSLAM_COORDINATOR"
    pid = jax.process_index()
    mesh = make_host_mesh()

    cfg = SlamConfig(sim=SimConfig(robot_steps=args.steps, seed=0))
    sim = frontend.simulate(cfg.sim)       # deterministic on every process
    graph, _ = frontend.build_graph(sim, cfg)
    opt_cfg = OptimizerConfig(iterations=args.iterations, solver="schur")
    gshard = shard_graph(graph, mesh)

    gn = GaussNewton(opt_cfg, solve=distributed_linearize_solve(opt_cfg, mesh))
    r = gn.optimize(gshard)
    est = np.asarray(r.graph.poses)        # replicated -> full copy locally

    t0 = time.perf_counter()
    for _ in range(args.reps):
        r = gn.optimize(gshard)
    est = np.asarray(r.graph.poses)
    wall = (time.perf_counter() - t0) / args.reps

    n = sim.poses_gt.shape[0]
    out = {
        "process": pid,
        "num_processes": jax.process_count(),
        "global_devices": jax.device_count(),
        "poses": n,
        "iters": int(r.iterations_run),
        "wall_s_per_opt": round(wall, 4),
        "gn_iters_per_s": round(int(r.iterations_run) / wall, 2),
        "ate_rmse": round(
            frontend.ate_rmse(est[:n], sim.poses_gt), 4
        ),
        "poses_checksum": float(np.float64(est.sum())),
    }
    with open(args.result_file + f".{pid}", "w") as f:
        json.dump(out, f)
    print(json.dumps(out), flush=True)


def launch(args) -> int:
    port = args.port
    results = tempfile.mktemp(prefix="toyslam_mh_")
    procs = []
    for pid in range(args.procs):
        env = dict(
            os.environ,
            JAX_PLATFORMS="cpu",
            XLA_FLAGS=(
                f"--xla_force_host_platform_device_count="
                f"{args.devices_per_proc}"
            ),
            TOYSLAM_COORDINATOR=f"127.0.0.1:{port}",
            TOYSLAM_NUM_PROCESSES=str(args.procs),
            TOYSLAM_PROCESS_ID=str(pid),
        )
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--steps", str(args.steps), "--iterations",
             str(args.iterations), "--reps", str(args.reps),
             "--result-file", results],
            env=env,
            stdout=subprocess.PIPE if pid else None,
            stderr=subprocess.DEVNULL if pid else None,
        ))
    rc = 0
    for pid, p in enumerate(procs):
        p.wait(timeout=1200)
        rc |= p.returncode
    if rc:
        print(json.dumps({"ok": False, "rc": rc}))
        return 1

    outs = []
    for pid in range(args.procs):
        with open(results + f".{pid}") as f:
            outs.append(json.load(f))
        os.unlink(results + f".{pid}")
    checks = {o["poses_checksum"] for o in outs}
    artifact = {
        "ok": len(checks) == 1,
        "bitwise_agreement_across_processes": len(checks) == 1,
        "num_processes": args.procs,
        "devices_per_process": args.devices_per_proc,
        "comm_backend": "gloo (cpu)",
        "result": outs[0],
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
    print(json.dumps(artifact))
    return 0 if artifact["ok"] else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--devices-per-proc", type=int, default=4)
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--iterations", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--port", type=int, default=29417)
    ap.add_argument("--result-file", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if args.worker:
        worker(args)
        return 0
    return launch(args)


if __name__ == "__main__":
    sys.exit(main())

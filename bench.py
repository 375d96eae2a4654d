"""Headline benchmark: GN iterations/s on the reference workload, on a GPU.

Runs the flagship pipeline (150-pose seeded sim 2D LiDAR graph, 10-iteration
damped Gauss-Newton, Schur/PCG solver) on the GPU and prints ONE JSON line
comparing against the measured reference baseline (BASELINE_MEASURED.json —
the reference's own Python optimizer, plus our native C++ engine as the
Eigen-class CPU comparator).

Timing: ``_REPS`` optimizes are enqueued back to back and the last result
is fenced with ``jax.block_until_ready``; the per-call time is the median
over ``_ROUNDS``, with every round reported.

Supervision: the measurement body runs in a subprocess with a hard
wall-clock deadline (``BENCH_DEADLINE_S``, default 600 s), so a hung device
cannot hang the benchmark, and the parent process never imports JAX (one
process per card).  A run that finds no GPU, dies, or hangs still prints
one JSON line, with ``value: null`` and the reason, and exits non-zero.
Timeouts kill the exact child process group (never by pattern).
``--worker`` runs the measurement body directly.
"""

from __future__ import annotations

import json
import os
import signal
import statistics
import subprocess
import sys
import time

_REPO = os.path.dirname(os.path.abspath(__file__))

_METRIC = "GN iterations/s (sim 2D LiDAR, 150 poses, damped GN, Schur/PCG)"
_REPS = 20  # optimizes enqueued back to back per round
_ROUNDS = 5


def _load_baseline():
    path = os.path.join(_REPO, "BASELINE_MEASURED.json")
    if os.path.exists(path):
        with open(path) as f:
            return json.load(f)
    return None


# ---------------------------------------------------------------------------
# worker: the actual measurement (runs in a supervised subprocess)
# ---------------------------------------------------------------------------


def worker():
    try:
        import toyslam_tpu  # noqa: F401  (installed package, if present)
    except ImportError:  # running from a source checkout
        sys.path.insert(0, _REPO)
    from toyslam_tpu import compile_cache

    compile_cache.enable()
    import jax
    import numpy as np

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"[bench-worker] no GPU: JAX found {dev.platform!r} devices",
              file=sys.stderr, flush=True)
        sys.exit(3)

    from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.sim import frontend

    cfg = SlamConfig(
        sim=SimConfig(robot_steps=150, seed=0),
        optimizer=OptimizerConfig(
            iterations=10, lr=0.2, solver="schur", pcg_precond="tridiag",
        ),
    )
    sim = frontend.simulate(cfg.sim)
    graph, _ = frontend.build_graph(sim, cfg)
    gt = np.asarray(sim.poses_gt)
    n_real = gt.shape[0]

    def phase(msg):
        # progress markers on stderr: the supervisor preserves the stderr
        # file across a deadline kill, so a hang is attributable to a phase
        print(f"[bench-worker] {msg}", file=sys.stderr, flush=True)

    gn = GaussNewton(cfg.optimizer)
    # host->device once: structure tables + arrays (the workload is repeated
    # optimization of a resident graph, as on the reference's server path)
    phase("device_put")
    gdev = jax.device_put(gn._prepare(graph))

    phase("compile+warmup")
    result = jax.block_until_ready(gn.optimize(gdev))
    est = np.asarray(result.graph.poses)[:n_real]
    iters_run = int(result.iterations_run)

    times = []
    for _ in range(_ROUNDS):
        t0 = time.perf_counter()
        r = None
        for _ in range(_REPS):
            r = gn.optimize(gdev)
        jax.block_until_ready(r)
        times.append((time.perf_counter() - t0) / _REPS)

    median = statistics.median(times)
    iters_per_s = iters_run / median

    # single-call latency, dispatch included
    t0 = time.perf_counter()
    jax.block_until_ready(gn.optimize(gdev))
    latency = time.perf_counter() - t0

    ate = frontend.ate_rmse(est, gt)
    ate_dr = frontend.ate_rmse(np.asarray(sim.poses_dr), gt)

    baseline = _load_baseline()
    vs = None
    vs_native = None
    if baseline and baseline.get("iters_per_s"):
        vs = iters_per_s / baseline["iters_per_s"]
    if baseline and baseline.get("native_cpu", {}).get("iters_per_s"):
        # strongest CPU comparator: our own Eigen-class native C++ engine
        # (scripts/measure_native_baseline.py)
        vs_native = iters_per_s / baseline["native_cpu"]["iters_per_s"]

    out = {
        "metric": _METRIC,
        "value": iters_per_s,
        "unit": "iter/s",
        "headline_stat": "median of rounds",
        "iters_per_s_best": iters_run / min(times),
        "vs_baseline": vs,
        "vs_native_cpu": vs_native,
        "ate_rmse": ate,
        "baseline_ate_rmse": baseline["final_ate_rmse"] if baseline else None,
        "dead_reckoning_ate_rmse": ate_dr,
        "iterations": iters_run,
        "wall_s_per_opt_median": median,
        "wall_s_per_opt_rounds": times,
        "latency_s_single_call": latency,
        "device": {
            "platform": dev.platform,
            "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
    }
    print(json.dumps(out), flush=True)


# ---------------------------------------------------------------------------
# supervisor: deadline + artifact-on-failure
# ---------------------------------------------------------------------------


def _tail_file(path: str, max_bytes: int = 2000) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            f.seek(max(0, size - max_bytes))
            return f.read().decode(errors="replace")
    except OSError:
        return "<no stderr>"


def _run_worker(deadline_s: float, selftest_hang: bool):
    """One supervised worker run.  Returns (json_line | None, reason)."""
    cmd = [sys.executable, os.path.abspath(__file__), "--worker"]
    if selftest_hang:
        cmd.append("--selftest-hang")
    # own process group so a timeout kills exactly this child tree —
    # never a kill-by-pattern.  Child stderr goes to a FILE so the
    # progress trace survives a deadline kill.
    errpath = os.path.join(_REPO, f".bench_worker_{os.getpid()}.stderr")
    with open(errpath, "w") as errf:
        proc = subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=errf,
            start_new_session=True, text=True,
        )
        try:
            out, _ = proc.communicate(timeout=deadline_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.wait()
            tail = _tail_file(errpath)
            return None, (
                f"deadline exceeded ({deadline_s:.0f}s) — hang; "
                f"last stderr: {tail[:200]}"
            )
    err = _tail_file(errpath, max_bytes=20000)
    try:
        os.unlink(errpath)
    except OSError:
        pass
    sys.stderr.write(err)
    if proc.returncode == 0:
        for line in reversed(out.splitlines()):
            line = line.strip()
            if line.startswith("{"):
                return line, None
    tail = (err.strip().splitlines() or ["<no stderr>"])[-1]
    return None, f"rc={proc.returncode}: {tail[:300]}"


def supervise(selftest_hang: bool = False) -> int:
    deadline = float(os.environ.get("BENCH_DEADLINE_S", "600"))
    line, reason = _run_worker(deadline, selftest_hang)
    if line is not None:
        print(line, flush=True)
        return 0
    print(f"# bench failed: {reason}", file=sys.stderr)
    print(json.dumps({
        "metric": _METRIC,
        "value": None,
        "unit": "iter/s",
        "failed": True,
        "reason": reason,
    }), flush=True)
    return 1


if __name__ == "__main__":
    if "--worker" in sys.argv:
        if "--selftest-hang" in sys.argv:
            time.sleep(3600)  # forced-hang path for the supervisor test
        worker()
    else:
        sys.exit(supervise(selftest_hang="--selftest-hang" in sys.argv))

"""Smoke test of the solver's main path on one NVIDIA GPU.

    python3 chip_smoke.py           # the four one-card phases below
    python3 chip_smoke.py --multi   # only the 4-GPU mesh checks

Phases, each through the entry points a user calls:

* ``ref150``   — ``app.main(["run", ...])`` on the 150-pose seeded
  sequence; ATE against the reference's, and the per-iteration chi^2 of
  the same optimize against a run on the host CPU (the plain reference).
* ``large10k`` — the 10k-pose x 10k-landmark ``schur_grid`` config, then
  its 2-lap revisit graph; final chi^2 at or below chi^2 at ground truth,
  and the general ``schur`` solver within 1% of it.
* ``ba3d``     — ``app.main(["ba3d", ...])`` at 128 poses x 512 landmarks,
  Huber 4 (the BA cell's robust kernel).
* ``serve``    — an in-process ``PyGraphServer`` answers 3 ``GraphClient``
  requests; each answer matches a local ``GaussNewton.optimize``.

Every phase prints one JSON line with its wall times and quality numbers.
The last line is ``{"ok": true, "device": {...}}`` only when every phase
passed; otherwise the script exits non-zero.  Without a GPU it exits
non-zero before any phase.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import io
import json
import subprocess
import sys
import time
import traceback

import jax
import numpy as np

# the reference's ATE (BASELINE_MEASURED.json final_ate_rmse), from its f64
# dense solver; this f32 Schur/PCG path lands within ~1e-3 of it
ATE_REF150 = 0.7550
ATE_TOL = 1e-2
# the same f32 program on two backends: only the order of sums differs.
# Measured on an H100: 5e-7 to 1.2e-6 over 24 runs, with and without the
# HIGHEST pins and with TF32 forced; 1e-5 leaves an 8x margin over that.
CHI2_CPU_RTOL = 1e-5
# two storage orders of the same system under a truncated (15-iteration)
# PCG solve, compounded over 15-20 GN iterations
SCHUR_VS_GRID_RTOL = 1e-2
# the codec carries float32 exactly; only the order of sums may differ
SERVE_RTOL = 1e-5


class GateFailed(RuntimeError):
    """A phase's output missed its quality gate."""


def _gate(ok: bool, what) -> None:
    # not ``assert``: the gates must hold under ``python -O`` too
    if not ok:
        raise GateFailed(what)


def _emit(rec: dict) -> None:
    print(json.dumps(rec), flush=True)


def _app(argv: list[str]) -> dict:
    """Run ``app.main(argv)`` and return its JSON metrics line."""
    from toyslam_tpu import app

    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = app.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise RuntimeError(f"app.main({argv}) returned {rc}")
    lines = [ln for ln in buf.getvalue().splitlines() if ln.startswith("{")]
    out = json.loads(lines[-1])
    out["wall_s"] = wall
    return out


def _timed(fn):
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _errors(res) -> np.ndarray:
    e = np.asarray(res.errors)
    return e[~np.isnan(e)]


def phase_ref150() -> dict:
    from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.sim import frontend

    m = _app(["run", "--steps", "150", "--solver", "schur"])
    ate = m["ate_rmse"]
    _gate(abs(ate - ATE_REF150) <= ATE_TOL, (ate, ATE_REF150))

    # the same optimize as `app run` (its defaults), on the GPU and on the
    # host CPU
    cfg = SlamConfig(
        sim=SimConfig(robot_steps=150, seed=0),
        optimizer=OptimizerConfig(iterations=10, lr=0.2, solver="schur"),
    )
    graph, _ = frontend.build_graph(frontend.simulate(cfg.sim), cfg)
    gn = GaussNewton(cfg.optimizer)
    res_gpu, t_gpu = _timed(lambda: gn.optimize(graph))
    _, t_gpu2 = _timed(lambda: gn.optimize(graph))
    cpu = jax.devices("cpu")[0]
    with jax.default_device(cpu):
        res_cpu = GaussNewton(cfg.optimizer).optimize(
            jax.device_put(graph, cpu)
        )
    e_gpu, e_cpu = _errors(res_gpu), _errors(res_cpu)
    _gate(e_gpu.shape == e_cpu.shape, (e_gpu, e_cpu))
    rel = float(np.max(np.abs(e_gpu - e_cpu) / np.abs(e_cpu)))
    _gate(rel <= CHI2_CPU_RTOL, (rel, e_gpu, e_cpu))
    return {
        "ate_rmse": ate,
        "ate_ref": ATE_REF150,
        "app_wall_s": m["wall_s"],
        "app_optimize_s": m["optimize_s"],
        "optimize_first_s": t_gpu,
        "optimize_steady_s": t_gpu2,
        "gn_iters": int(res_gpu.iterations_run),
        "pcg_iters": np.asarray(res_gpu.pcg_iters)[: e_gpu.size].tolist(),
        "chi2_gpu": e_gpu.tolist(),
        "chi2_cpu": e_cpu.tolist(),
        "chi2_max_rel_dev_vs_cpu": rel,
    }


def _chi2_at(graph, poses, lms, cfg) -> float:
    """Robust chi^2 of ``graph`` with its first poses/landmarks replaced."""
    import functools

    from toyslam_tpu.ops import assemble

    p = np.asarray(graph.poses).copy()
    lm = np.asarray(graph.landmarks).copy()
    p[: poses.shape[0]] = poses
    lm[: lms.shape[0]] = lms
    err = jax.jit(functools.partial(
        assemble.total_error, huber_delta=cfg.huber_delta,
        exact_odom_jacobians=cfg.exact_odom_jacobians,
    ))
    return float(err(graph.with_state(p, lm)))


def _large_case(name, graph, poses_gt, lms_gt, cfg) -> dict:
    import dataclasses

    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.sim import frontend

    n = poses_gt.shape[0]
    chi2_gt = _chi2_at(graph, poses_gt, lms_gt, cfg)
    out = {"case": name, "poses": n,
           "landmarks": int(np.asarray(graph.lm_mask).sum()),
           "lm_edges": int(np.asarray(graph.lm_edges.mask).sum()),
           "chi2_gt": chi2_gt}
    for solver in ("schur_grid", "schur"):
        c = dataclasses.replace(cfg, solver=solver)
        gn = GaussNewton(c)
        g = gn._prepare(graph)
        res, t_first = _timed(lambda: gn.optimize(g))
        _, t_steady = _timed(lambda: gn.optimize(g))
        final = res.graph
        chi2_final = _chi2_at(
            graph, np.asarray(final.poses)[:n],
            np.asarray(final.landmarks)[: lms_gt.shape[0]], c,
        )
        out[solver] = {
            "optimize_first_s": t_first,
            "optimize_steady_s": t_steady,
            "gn_iters": int(res.iterations_run),
            "pcg_iters": np.asarray(res.pcg_iters)[
                : int(res.iterations_run)].tolist(),
            "chi2_first": float(_errors(res)[0]),
            "chi2_final": chi2_final,
            "ate_rmse": frontend.ate_rmse(
                np.asarray(final.poses)[:n], poses_gt),
        }
    grid, gen = out["schur_grid"]["chi2_final"], out["schur"]["chi2_final"]
    out["schur_vs_grid_rel_dev"] = abs(gen - grid) / grid
    _gate(grid <= chi2_gt, (name, grid, chi2_gt))
    _gate(out["schur_vs_grid_rel_dev"] <= SCHUR_VS_GRID_RTOL, out)
    return out


def phase_large10k() -> dict:
    from toyslam_tpu.config import OptimizerConfig
    from toyslam_tpu.sim import synthetic

    # the large-sparse-10k cell: truncated-Newton budget, grid storage
    cfg = OptimizerConfig(
        iterations=15, lr=1.0, solver="schur_grid",
        exact_odom_jacobians=True, pcg_tol=1e-2,
        pcg_max_iters=15, pcg_restart_every=15,
        pcg_precond="tridiag+coarse", pcg_coarse_group=32,
        pcg_precond_refresh=5,
    )
    cases = []
    g, p, lm = synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=10_000, obs_per_pose=6, seed=0,
    )
    cases.append(_large_case("10k", g, p, lm, cfg))
    g, p, lm = synthetic.make_large_problem(
        num_poses=10_000, num_landmarks=5_000, obs_per_pose=6, seed=0,
        laps=2,
    )
    import dataclasses

    cases.append(_large_case(
        "10k-revisit", g, p, lm, dataclasses.replace(cfg, iterations=20)
    ))
    return {"cases": cases}


def phase_ba3d() -> dict:
    m = _app(["ba3d", "--poses", "128", "--landmarks", "512", "--obs", "24",
              "--huber", "4"])
    _gate(m["ate_final"] < 0.3 * m["ate_initial"], m)
    _gate(m["chi2_final"] < m["chi2_first"], m)
    return m


def phase_serve() -> dict:
    from toyslam_tpu.config import OptimizerConfig, SimConfig, SlamConfig
    from toyslam_tpu.io.client import GraphClient
    from toyslam_tpu.io.server import PyGraphServer, jax_optimize_fn
    from toyslam_tpu.optimizer import GaussNewton
    from toyslam_tpu.sim import frontend

    cfg = OptimizerConfig(solver="schur")
    graphs = []
    for seed in range(3):
        sc = SlamConfig(sim=SimConfig(robot_steps=150, seed=seed))
        graphs.append(frontend.build_graph(frontend.simulate(sc.sim), sc)[0])

    async def go(port):
        client = GraphClient("127.0.0.1", port)
        await client.connect()
        outs, lat = [], []
        for g in graphs:
            t0 = time.perf_counter()
            outs.append(await client.optimize(g))
            lat.append(time.perf_counter() - t0)
        await client.close()
        return outs, lat

    with PyGraphServer(jax_optimize_fn(cfg), port=0) as server:
        outs, latency = asyncio.run(go(server.port))
    gn = GaussNewton(cfg)
    devs = []
    for g, out in zip(graphs, outs):
        ref = jax.block_until_ready(gn.optimize(g).graph)
        for got, want in ((out.poses, ref.poses),
                          (out.landmarks, ref.landmarks)):
            got, want = np.asarray(got), np.asarray(want)
            devs.append(float(
                np.max(np.abs(got - want)) / max(np.max(np.abs(want)), 1.0)
            ))
    _gate(max(devs) <= SERVE_RTOL, devs)
    return {"requests": len(graphs), "latency_s": latency,
            "max_rel_dev_vs_local": max(devs)}


def phase_multi(n: int) -> dict:
    import __graft_entry__

    t0 = time.perf_counter()
    out = __graft_entry__.multichip_checks(n)
    out["wall_s"] = time.perf_counter() - t0
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--multi", action="store_true",
                    help="run only the 4-GPU mesh checks")
    args = ap.parse_args(argv)

    # the GPU, plus the host CPU for the ref150 reference run
    jax.config.update("jax_platforms", "cuda,cpu")
    try:
        devices = jax.devices()
    except RuntimeError as e:
        print(f"chip_smoke: no GPU backend: {e}", file=sys.stderr)
        return 2
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU: JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    want = 4 if args.multi else 1
    if len(devices) < want:
        print(f"chip_smoke: need {want} GPUs, have {len(devices)}",
              file=sys.stderr)
        return 2

    from toyslam_tpu import compile_cache

    cache = compile_cache.enable()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    print(smi.stdout.strip(), flush=True)
    print(f"# jax {jax.__version__}, compile cache {cache}", flush=True)

    if args.multi:
        phases = [("multi", lambda: phase_multi(want))]
    else:
        phases = [("ref150", phase_ref150), ("large10k", phase_large10k),
                  ("ba3d", phase_ba3d), ("serve", phase_serve)]
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            rec = fn()
        except Exception as e:  # reported below; the run exits non-zero
            traceback.print_exc()
            _emit({"phase": name, "ok": False, "error": repr(e),
                   "wall_s": time.perf_counter() - t0})
            failed.append(name)
            continue
        _emit({"phase": name, "ok": True,
               "wall_s": time.perf_counter() - t0, **rec})
    if failed:
        print(f"chip_smoke: failed phases: {failed}", file=sys.stderr)
        return 1
    dev = jax.devices()[0]
    _emit({"ok": True, "device": {"platform": dev.platform,
                                  "kind": dev.device_kind,
                                  "count": len(jax.devices())}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""bench.py's supervisor: a run that finds no GPU, or hangs, fails with a
non-zero exit and still prints one JSON line saying why — never a number
from another platform."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "bench.py")


def _run_supervisor(extra_args, env_overrides, timeout=120):
    env = dict(os.environ)
    env.update(env_overrides)
    return subprocess.run(
        [sys.executable, BENCH] + extra_args,
        capture_output=True, text=True, env=env, timeout=timeout,
    )


def _last_json_line(stdout: str):
    lines = [ln for ln in stdout.splitlines() if ln.strip().startswith("{")]
    assert lines, f"no JSON line in stdout: {stdout!r}"
    return json.loads(lines[-1])


@pytest.mark.slow
def test_forced_hang_still_emits_artifact():
    """The worker hangs -> the supervisor kills it at its deadline and
    still prints a parseable JSON artifact with the failure reason."""
    proc = _run_supervisor(["--selftest-hang"], {"BENCH_DEADLINE_S": "2"})
    assert proc.returncode == 1
    rec = _last_json_line(proc.stdout)
    assert rec["value"] is None
    assert rec["failed"] is True
    assert "hang" in rec["reason"]


def test_no_gpu_fails():
    """On a CPU-only platform the worker refuses to measure: the run exits
    non-zero and reports no value."""
    proc = _run_supervisor([], {"JAX_PLATFORMS": "cpu"})
    assert proc.returncode == 1, proc.stderr[-2000:]
    rec = _last_json_line(proc.stdout)
    assert rec["value"] is None
    assert rec["failed"] is True
    assert "rc=3" in rec["reason"]
    assert "no GPU" in proc.stderr

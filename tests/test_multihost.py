"""Multi-process (multi-host) distributed BA via jax.distributed + Gloo.

Spawns real separate worker processes (the launcher in
scripts/launch_multihost.py), each with its own fake-device CPU mesh slice,
and checks the collective Gauss-Newton agrees bitwise across processes —
the testable stand-in for the reference's missing multi-node story
(SURVEY.md §2.3).
"""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.slow
def test_two_process_distributed_ba_agrees():
    env = dict(os.environ)
    # the launcher sets worker envs itself; scrub our conftest's forced CPU
    # config so workers configure from scratch
    proc = subprocess.run(
        [sys.executable,
         os.path.join(REPO, "scripts", "launch_multihost.py"),
         "--procs", "2", "--devices-per-proc", "2",
         "--steps", "60", "--iterations", "4", "--reps", "1",
         "--port", "29431"],
        capture_output=True, text=True, timeout=900, env=env, cwd=REPO,
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    artifact = json.loads(proc.stdout.strip().splitlines()[-1])
    assert artifact["ok"] is True
    assert artifact["bitwise_agreement_across_processes"] is True
    assert artifact["result"]["global_devices"] == 4
    assert artifact["result"]["ate_rmse"] < 3.0

"""What stays of the device selection and its entry points on the CPU:
options of the removed kernel stack are rejected, the compilation cache
lands where the helper says, and chip_smoke.py refuses to run without a
GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from toyslam_tpu.config import OptimizerConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize(
    "option,value",
    [("pcg_backend", "xla"), ("pcg_fused_chunk", 16), ("edge_backend", "xla")],
)
def test_removed_options_rejected(option, value):
    with pytest.raises(TypeError, match=option):
        OptimizerConfig(**{option: value})


def _copy_package(tmp_path):
    shutil.copytree(
        os.path.join(REPO, "toyslam_tpu"), tmp_path / "toyslam_tpu",
        ignore=shutil.ignore_patterns("__pycache__"),
    )


_COMPILE = (
    "from toyslam_tpu import compile_cache; import jax, jax.numpy as jnp;"
    "print(compile_cache.enable());"
    "jax.jit(lambda x: jnp.sin(x) * 2)(jnp.ones(8)).block_until_ready()"
)


def _run_cache_probe(tmp_path, env_extra):
    """Compile one program with a copy of the package under ``tmp_path``
    as the checkout; returns the cache directory the helper chose."""
    _copy_package(tmp_path)
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(tmp_path),
               JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS="0")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    env.update(env_extra)
    proc = subprocess.run(
        [sys.executable, "-c", _COMPILE], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    return proc.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_to_checkout(tmp_path):
    path = _run_cache_probe(tmp_path, {})
    assert path == str(tmp_path / ".jax_cache")
    assert os.listdir(tmp_path / ".jax_cache")


def test_compile_cache_follows_env(tmp_path):
    own = tmp_path / "elsewhere"
    path = _run_cache_probe(tmp_path, {"JAX_COMPILATION_CACHE_DIR": str(own)})
    assert path == str(own)
    assert os.listdir(own)
    assert not (tmp_path / ".jax_cache").exists()


@pytest.mark.parametrize("alone", [False, True])
def test_chip_smoke_fails_without_gpu(tmp_path, alone):
    """On the CPU (and, alone, without the package) the script exits
    non-zero and never reports success."""
    script = os.path.join(REPO, "chip_smoke.py")
    cwd = REPO
    if alone:
        shutil.copy(script, tmp_path)
        script, cwd = str(tmp_path / "chip_smoke.py"), tmp_path
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    proc = subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout

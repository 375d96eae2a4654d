"""Test config: run on CPU with 8 fake devices so sharding tests work
anywhere (the reference has no tests at all — SURVEY.md §4)."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", False)
# entry points under test place the persistent compilation cache
# (toyslam_tpu/compile_cache.py); the suite itself writes none
jax.config.update("jax_enable_compilation_cache", False)

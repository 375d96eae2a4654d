"""Where JAX keeps its persistent compilation cache.

Every entry point (``app.main``, ``bench.py``, ``chip_smoke.py`` and the
scripts through ``scripts/_bootstrap.py``) calls :func:`enable` before its
first compile, so all processes of one checkout share one cache.
"""

from __future__ import annotations

import os

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def enable() -> str:
    """Point JAX's persistent compilation cache at one directory; return it.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here.  Otherwise the cache lives at
    ``<checkout>/.jax_cache``, which ``.gitignore`` lists.
    """
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path

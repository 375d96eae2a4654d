"""Make ``toyslam_tpu`` importable when scripts run from a source checkout,
and place JAX's compilation cache (toyslam_tpu/compile_cache.py).

No-op import-wise when the package is installed (pyproject.toml); otherwise
falls back to the repo root.  Scripts just ``import _bootstrap`` (the
script's own directory is always on ``sys.path`` when invoked as
``python scripts/x.py``).
"""

import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

try:
    import toyslam_tpu  # noqa: F401
except ImportError:
    sys.path.insert(0, REPO)

from toyslam_tpu import compile_cache  # noqa: E402

compile_cache.enable()

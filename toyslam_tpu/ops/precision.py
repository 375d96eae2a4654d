"""Full-f32 einsum for the numerical core.

At default precision XLA may run a float32 contraction at reduced
precision (TF32 on GPU tensor cores keeps about three decimal digits).
Gauss-Newton normal equations with a 1e6 gauge prior lose the low-order
bits that carry the actual signal, and SE(3) rotation products feed the
residuals directly.  Contractions in the solver core go through this
wrapper, pinning HIGHEST precision (full float32).  The per-edge blocks
are tiny, so the cost is invisible; accuracy is not negotiable here.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

einsum = functools.partial(jnp.einsum, precision=jax.lax.Precision.HIGHEST)

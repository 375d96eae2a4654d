"""Tiny-block linear algebra as broadcast + reduce (elementwise).

``jnp.einsum`` lowers contractions to ``dot_general``, which XLA hands to a
matrix-multiply routine — wasteful for batched 3x3/3x2/2x2 blocks, where
each tiny block is far below a matrix unit's tile.  Writing the same
products as elementwise multiplies with explicit ``sum`` over the
2-or-3-long axes keeps them at full f32 precision (no dot, so no TF32) and
lets XLA fuse them with neighbors.

Shapes use trailing block axes: ``A [..., a, b]``, vectors ``x [..., b]``.
"""

from __future__ import annotations

import jax.numpy as jnp


def mv(A, x):
    """``A @ x``: [..., a, b] x [..., b] -> [..., a]."""
    return jnp.sum(A * x[..., None, :], axis=-1)


def mtv(A, x):
    """``A^T @ x``: [..., a, b] x [..., a] -> [..., b]."""
    return jnp.sum(A * x[..., :, None], axis=-2)


def mm(A, B):
    """``A @ B``: [..., a, b] x [..., b, c] -> [..., a, c]."""
    return jnp.sum(A[..., :, :, None] * B[..., None, :, :], axis=-2)


def mtm(A, B):
    """``A^T @ B``: [..., a, b] x [..., a, c] -> [..., b, c]."""
    return jnp.sum(A[..., :, :, None] * B[..., :, None, :], axis=-3)


def quad(J, W):
    """``J^T @ W @ J``: [..., r, d] x [..., r, r] -> [..., d, d]."""
    return mtm(J, mm(W, J))


def vwv(x, W, y):
    """``x^T W y`` -> [...]."""
    return jnp.sum(x[..., :, None] * W * y[..., None, :], axis=(-2, -1))

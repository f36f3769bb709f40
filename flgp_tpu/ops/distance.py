"""Pairwise squared-Euclidean distances.

The reference expands ‖x‖² − 2x·u + ‖u‖² in row batches of 100 with TBB
threads (src/Utils.cpp:102-192).  Here the −2XUᵀ term is a single matmul;
callers chunk rows (via lax.map) when the (n, s) product would not fit in
device memory.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from ..config import PRECISION


def sqdist(X: jnp.ndarray, U: jnp.ndarray) -> jnp.ndarray:
    """All-pairs squared Euclidean distances, shape (n, s).

    Matches the reference's expansion exactly (src/Utils.cpp:121), including
    its potential small negative values from cancellation — callers that need
    nonnegativity clamp explicitly.  The cross term runs at HIGHEST precision:
    the cancellation amplifies reduced-precision error into wrong kNN
    graphs.
    """
    x2 = jnp.sum(X * X, axis=1, keepdims=True)
    u2 = jnp.sum(U * U, axis=1, keepdims=True)
    G = jnp.matmul(X, U.T, precision=PRECISION)
    return x2 - 2.0 * G + u2.T


def sqdist_blocked(X: jnp.ndarray, U: jnp.ndarray, block: int = 8192) -> jnp.ndarray:
    """Row-blocked variant for large n (bounds the live (block, s) tile)."""
    n = X.shape[0]
    if n <= block:
        return sqdist(X, U)
    pad = (-n) % block
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    blocks = Xp.reshape(-1, block, X.shape[1])
    out = jax.lax.map(lambda xb: sqdist(xb, U), blocks)
    return out.reshape(-1, U.shape[0])[:n]

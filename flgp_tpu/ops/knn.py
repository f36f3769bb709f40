"""Brute-force batched k-nearest-neighbors against the anchor set.

The reference does per-row std::partial_sort over an (n, s) distance matrix
under TBB (src/Utils.cpp:72-192).  Here it is one matmul for the distances
plus ``lax.top_k`` on the negated distances — fixed shapes, no
data-dependent control flow.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .distance import sqdist


class KnnResult(NamedTuple):
    indices: jnp.ndarray    # (n, r) int32 — columns of the r nearest anchors
    sqdists: jnp.ndarray    # (n, r) — squared distances (reference keeps d², src/Utils.cpp:165)


def knn(X: jnp.ndarray, U: jnp.ndarray, r: int, block: int = 8192) -> KnnResult:
    """r nearest anchors (by squared Euclidean distance) for each row of X:
    a blocked (n, s) distance matmul plus ``lax.top_k`` on the negated
    distances.

    Ties are broken by anchor index (top_k is stable), matching
    partial_sort's behavior on strict-weak ordering closely enough for
    downstream use.
    """
    n = X.shape[0]

    def one_block(xb: jnp.ndarray) -> KnnResult:
        d = sqdist(xb, U)
        neg, idx = jax.lax.top_k(-d, r)
        return KnnResult(idx.astype(jnp.int32), -neg)

    if n <= block:
        return one_block(X)

    pad = (-n) % block
    Xp = jnp.pad(X, ((0, pad), (0, 0)))
    blocks = Xp.reshape(-1, block, X.shape[1])
    res = jax.lax.map(one_block, blocks)
    return KnnResult(
        res.indices.reshape(-1, r)[:n],
        res.sqdists.reshape(-1, r)[:n],
    )

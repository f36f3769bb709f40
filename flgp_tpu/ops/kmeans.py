"""Anchor-point subsampling: k-means, random, and mini-batch k-means.

The reference calls back into R for this (stats::kmeans with iter.max=100 and
ClusterR::MiniBatchKmeans; src/Utils.cpp:32-68).  Here each variant is a
jit-compiled JAX routine: distance matmuls, centroid updates via
segment-sums, restarts batched with vmap.

Returned clusters double as the "cluster sizes" column the cluster-normalized
graph Laplacian consumes (src/Utils.cpp:44-45, 59-62).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import Subsample
from .distance import sqdist, sqdist_blocked
from .knn import knn


class SubsampleResult(NamedTuple):
    centers: jnp.ndarray   # (s, d)
    counts: jnp.ndarray    # (s,) — points assigned to each center


def _assign(X: jnp.ndarray, centers: jnp.ndarray) -> Tuple[jnp.ndarray, jnp.ndarray]:
    d = sqdist_blocked(X, centers)
    assign = jnp.argmin(d, axis=1)
    mind = jnp.min(d, axis=1)
    return assign, mind


def _update(X: jnp.ndarray, assign: jnp.ndarray, s: int, old: jnp.ndarray):
    n, d = X.shape
    counts = jnp.zeros((s,), dtype=X.dtype).at[assign].add(1.0)
    sums = jnp.zeros((s, d), dtype=X.dtype).at[assign].add(X)
    centers = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts, 1.0)[:, None], old)
    return centers, counts


def lloyd(
    X: jnp.ndarray, init: jnp.ndarray, iters: int = 100
) -> Tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Lloyd iterations with early exit once assignments stabilize.

    Returns (centers, counts, total within-cluster SS).
    """
    s = init.shape[0]
    assign0 = jnp.full((X.shape[0],), -1, dtype=jnp.int32)

    def cond(state):
        i, _, _, changed = state
        return jnp.logical_and(i < iters, changed)

    def body(state):
        i, centers, assign, _ = state
        new_assign, _ = _assign(X, centers)
        new_assign = new_assign.astype(jnp.int32)
        centers, _ = _update(X, new_assign, s, centers)
        changed = jnp.any(new_assign != assign)
        return i + 1, centers, new_assign, changed

    _, centers, assign, _ = jax.lax.while_loop(
        cond, body, (jnp.int32(0), init, assign0, jnp.bool_(True))
    )
    assign, mind = _assign(X, centers)
    counts = jnp.zeros((s,), dtype=X.dtype).at[assign].add(1.0)
    wss = jnp.sum(mind)
    return centers, counts, wss


def _random_rows(key: jax.Array, X: jnp.ndarray, s: int) -> jnp.ndarray:
    idx = jax.random.choice(key, X.shape[0], shape=(s,), replace=False)
    return X[idx]


def _kmeanspp_rows(key: jax.Array, X: jnp.ndarray, s: int) -> jnp.ndarray:
    """k-means++ seeding (Arthur & Vassilvitskii 2007): each next center is a
    row drawn with probability ∝ squared distance to the nearest chosen
    center.  One lax.scan of s steps, each an O(n·d) distance update — far
    better Lloyd basins than random rows (the reference leans on R's
    Hartigan-Wong algorithm for the same effect, src/Utils.cpp:37-42)."""
    n, d = X.shape
    k0, kscan = jax.random.split(key)
    i0 = jax.random.randint(k0, (), 0, n)
    c0 = X[i0]
    mind0 = jnp.sum((X - c0[None, :]) ** 2, axis=1)

    def step(carry, k):
        mind = carry
        # Gumbel-max sample ∝ mind without normalizing (mind can be ~0)
        logits = jnp.log(jnp.maximum(mind, 1e-30))
        idx = jnp.argmax(logits + jax.random.gumbel(k, (n,), logits.dtype))
        c = X[idx]
        dist = jnp.sum((X - c[None, :]) ** 2, axis=1)
        return jnp.minimum(mind, dist), c

    _, centers_rest = jax.lax.scan(step, mind0, jax.random.split(kscan, s - 1))
    return jnp.concatenate([c0[None, :], centers_rest], axis=0)


def _kmeanspar_rows(
    key: jax.Array, X: jnp.ndarray, s: int, rounds: int = 4,
    oversample: float = 2.0, polish_iters: int = 5,
) -> jnp.ndarray:
    """k-means‖ seeding (Bahmani et al. 2012) with static shapes.

    k-means++'s s−1 *sequential* O(n·d) distance updates are the classic
    serial-seeding bottleneck on accelerators (it dominated the n=1e6
    spectral stage).  k-means‖ replaces them with ``rounds`` batched passes:
    each round draws a fixed block of B ≈ oversample·s/rounds candidates
    with probability ∝ d²(x, nearest chosen) — Gumbel-top-B is exactly
    weighted sampling without replacement, so the variable-size Bernoulli
    draw of the paper becomes a static top_k — then one blocked kNN pass
    updates the distances.  The ~2s candidates are weighted by their 1-NN
    mass and reduced to s seeds by weighted k-means++ *on the candidate set*
    (O(s·C·d) total — trivial) plus a few weighted Lloyd polish iterations.

    Sequential depth: rounds + s tiny candidate-set steps, vs k-means++'s
    s − 1 full-data steps.  Replaces the quality role of R's Hartigan–Wong
    (src/Utils.cpp:37-42) without its sequential passes.
    """
    n, d = X.shape
    B = max(-(-int(oversample * s) // rounds), 1)
    C = 1 + rounds * B
    k0, kr, kpp = jax.random.split(key, 3)
    i0 = jax.random.randint(k0, (), 0, n)
    c0 = X[i0]
    mind0 = jnp.sum((X - c0[None, :]) ** 2, axis=1)

    def round_step(mind, k):
        logits = jnp.log(jnp.maximum(mind, 1e-30))
        _, idx = jax.lax.top_k(logits + jax.random.gumbel(k, (n,), logits.dtype), B)
        cands = X[idx]
        nd = knn(X, cands, 1).sqdists[:, 0]
        return jnp.minimum(mind, nd), cands

    _, cr = jax.lax.scan(round_step, mind0, jax.random.split(kr, rounds))
    cands = jnp.concatenate([c0[None, :], cr.reshape(rounds * B, d)], axis=0)

    # weight candidates by their 1-NN mass over the full dataset
    assign = knn(X, cands, 1).indices[:, 0]
    w = jnp.zeros((C,), X.dtype).at[assign].add(1.0)

    # weighted k-means++ over the candidate set (C ≈ 2s: each step is O(C·d))
    dcc = jnp.maximum(sqdist(cands, cands), 0.0)
    j0 = jnp.argmax(w)
    c_first = cands[j0]

    def pp_step(mindc, k):
        logits = jnp.log(jnp.maximum(w * mindc, 1e-30))
        j = jnp.argmax(logits + jax.random.gumbel(k, (C,), logits.dtype))
        return jnp.minimum(mindc, dcc[j]), cands[j]

    _, rest = jax.lax.scan(pp_step, dcc[j0], jax.random.split(kpp, s - 1))
    centers = jnp.concatenate([c_first[None, :], rest], axis=0)

    # weighted Lloyd polish on the candidate set
    def lloyd_step(centers, _):
        a = jnp.argmin(sqdist(cands, centers), axis=1)
        cw = jnp.zeros((s,), X.dtype).at[a].add(w)
        csum = jnp.zeros((s, d), X.dtype).at[a].add(w[:, None] * cands)
        new = jnp.where(cw[:, None] > 0, csum / jnp.maximum(cw, 1.0)[:, None], centers)
        return new, None

    centers, _ = jax.lax.scan(lloyd_step, centers, None, length=polish_iters)
    return centers


def kmeans(
    key: jax.Array, X: jnp.ndarray, s: int, nstart: int = 1, iters: int = 100,
    init: str = "auto",
) -> SubsampleResult:
    """k-means with ``nstart`` restarts, best by within-cluster SS
    (mirrors stats::kmeans semantics, src/Utils.cpp:37-42).

    ``init``: "auto" seeds with k-means‖ when the data is large enough for
    the serial k-means++ scan to hurt (n ≥ 4s and s ≥ 64) and k-means++
    otherwise; "kmeans||", "kmeans++", and "random" force a scheme."""
    n = X.shape[0]
    if init == "auto":
        init = "kmeans||" if (n >= 4 * s and s >= 64) else "kmeans++"
    seed_fn = {
        "kmeans||": _kmeanspar_rows,
        "kmeans++": _kmeanspp_rows,
        "random": _random_rows,
    }[init]
    keys = jax.random.split(key, nstart)

    def one(k):
        return lloyd(X, seed_fn(k, X, s), iters)

    centers, counts, wss = jax.vmap(one)(keys)
    best = jnp.argmin(wss)
    return SubsampleResult(centers[best], counts[best])


def minibatch_kmeans(
    key: jax.Array,
    X: jnp.ndarray,
    s: int,
    batch_size: int | None = None,
    iters: int = 100,
    nstart: int = 1,
) -> SubsampleResult:
    """Sculley-style mini-batch k-means (replaces ClusterR::MiniBatchKmeans,
    src/Utils.cpp:50-56; reference uses batch_size = 10 s).

    Final counts come from a full 1-NN assignment pass, exactly as the
    reference computes them for this method (src/Utils.cpp:59-62).
    """
    n = X.shape[0]
    if batch_size is None:
        batch_size = min(10 * s, n)
    batch_size = min(batch_size, n)

    def one_start(k):
        kinit, kiter = jax.random.split(k)
        centers0 = _random_rows(kinit, X, s)
        ncounts0 = jnp.zeros((s,), dtype=X.dtype)
        # all minibatch indices drawn up front in ONE op: the per-step
        # choice(replace=False) this replaces was an O(n)-work *sequential*
        # host-of-the-loop permutation per iteration — it dominated the
        # n=1e6 spectral stage (~90% of wall-clock).  With-replacement
        # within a batch is immaterial to Sculley's update.
        bidxs = jax.random.randint(kiter, (iters, batch_size), 0, n)

        def step(carry, bidx):
            centers, ncounts = carry
            Xb = X[bidx]
            assign, _ = _assign(Xb, centers)
            bc = jnp.zeros((s,), dtype=X.dtype).at[assign].add(1.0)
            bsum = jnp.zeros_like(centers).at[assign].add(Xb)
            ncounts = ncounts + bc
            lr = jnp.where(ncounts > 0, bc / jnp.maximum(ncounts, 1.0), 0.0)
            bmean = bsum / jnp.maximum(bc, 1.0)[:, None]
            centers = centers + lr[:, None] * (bmean - centers)
            return (centers, ncounts), None

        (centers, _), _ = jax.lax.scan(step, (centers0, ncounts0), bidxs)
        _, mind = _assign(X, centers)
        return centers, jnp.sum(mind)

    centers, wss = jax.vmap(one_start)(jax.random.split(key, nstart))
    best = jnp.argmin(wss)
    centers = centers[best]
    labels = knn(X, centers, 1).indices[:, 0]
    counts = jnp.zeros((s,), dtype=X.dtype).at[labels].add(1.0)
    return SubsampleResult(centers, counts)


def random_subsample(key: jax.Array, X: jnp.ndarray, s: int) -> SubsampleResult:
    """Uniform row subsample (src/Utils.cpp:46-48).  Counts come from a 1-NN
    pass so that cluster-normalized Laplacians remain usable (the reference
    would fault on this combination)."""
    centers = _random_rows(key, X, s)
    labels = knn(X, centers, 1).indices[:, 0]
    counts = jnp.zeros((s,), dtype=X.dtype).at[labels].add(1.0)
    return SubsampleResult(centers, counts)


def subsample(
    key: jax.Array,
    X: jnp.ndarray,
    s: int,
    method: Subsample = Subsample.KMEANS,
    nstart: int = 1,
    iters: int = 100,
) -> SubsampleResult:
    """Dispatch on the subsample method (src/Utils.cpp:32-68)."""
    method = Subsample(method)
    if method == Subsample.KMEANS:
        return kmeans(key, X, s, nstart=nstart, iters=iters)
    if method == Subsample.RANDOM:
        return random_subsample(key, X, s)
    if method == Subsample.MINIBATCH_KMEANS:
        return minibatch_kmeans(key, X, s, nstart=nstart, iters=iters)
    raise ValueError(f"unsupported subsample method: {method}")

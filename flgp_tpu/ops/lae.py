"""Local Anchor Embedding: batched simplex-constrained least squares.

Per data point the reference solves  min_z ‖x − zᵀU_i‖²  s.t. z ∈ Δ^{r-1}
over its r nearest anchors with Nesterov-accelerated projected gradient and
backtracking line search, one TBB task per point (src/lae.cpp:15-153).

Batched form: the objective is quadratic, so the backtracking condition
g(z) ≤ g̃(z) holds for any step 1/β with β ≥ λmax(U_iU_iᵀ).  We therefore run
fixed-iteration FISTA with a per-point Gershgorin bound on λmax — identical
unique minimizer, no data-dependent control flow, everything batched over all
n points at once (no vmap-of-scalar-loops; pure (n, r)-shaped tensor ops).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..config import PRECISION
from .pallas_kernels import lae_fista_t


def project_simplex(v: jnp.ndarray) -> jnp.ndarray:
    """Euclidean projection of each row of v onto the probability simplex.

    Batched sort + cumulative-sum thresholding (src/lae.cpp:137-153).
    """
    r = v.shape[-1]
    u = jnp.sort(v, axis=-1)[..., ::-1]
    cssv = jnp.cumsum(u, axis=-1)
    k = jnp.arange(1, r + 1, dtype=v.dtype)
    cond = u - (cssv - 1.0) / k > 0
    # rho = largest k with cond true (cond is monotone in the sorted order)
    rho = jnp.sum(cond, axis=-1)
    rho = jnp.maximum(rho, 1)
    theta = (jnp.take_along_axis(cssv, (rho - 1)[..., None], axis=-1).squeeze(-1) - 1.0) / rho.astype(v.dtype)
    return jnp.maximum(v - theta[..., None], 0.0)


def lae_weights(
    X: jnp.ndarray,
    anchors: jnp.ndarray,
    knn_idx: jnp.ndarray,
    iters: int = 150,
) -> jnp.ndarray:
    """Anchor-embedding weights, shape (n, r): row i solves the simplex LSQ
    over anchors[knn_idx[i]].  Runs :func:`lae_weights_t` on the
    feature-major inputs of :func:`assemble_lae_gram_t`."""
    return lae_weights_t(*assemble_lae_gram_t(X, anchors, knn_idx), iters).T


def assemble_lae_gram_t(X: jnp.ndarray, anchors: jnp.ndarray, knn_idx: jnp.ndarray):
    """Feature-major FISTA inputs for every point: Gt (r², n) with row
    i·r + j holding U_i·U_j, and bt (r, n) with row k holding U_k·x, where
    U_k = anchors[knn_idx[:, k]].  The point axis is minor, so the Triton
    kernel's loads are coalesced."""
    n, r = knn_idx.shape
    Ui = anchors[knn_idx]                                      # (n, r, d)
    Gt = jnp.einsum("nrd,nsd->rsn", Ui, Ui, precision=PRECISION).reshape(r * r, n)
    bt = jnp.einsum("nd,nrd->rn", X, Ui, precision=PRECISION)
    return Gt, bt


def lae_weights_t(Gt: jnp.ndarray, bt: jnp.ndarray, iters: int = 150) -> jnp.ndarray:
    """FISTA simplex weights (r, n) from feature-major Gt (r², n), bt (r, n)
    — the one place the kernel is chosen, per lowering with
    ``lax.platform_dependent``: a CUDA lowering runs the Pallas-Triton
    kernel (``ops.pallas_kernels.lae_fista_t``), every other lowering the
    XLA scan :func:`_fista_t_xla`.  Both take f32 and f64 inputs.  The
    kernel has no gradient rule; no caller differentiates through the
    weights.  Safe inside ``shard_map`` and ``lax.map``; not inside
    ``vmap`` on the GPU (see ``ops.pallas_kernels``)."""
    return jax.lax.platform_dependent(
        Gt, bt,
        cuda=functools.partial(lae_fista_t, iters=iters),
        default=functools.partial(_fista_t_xla, iters=iters),
    )


def _fista_t_xla(Gt: jnp.ndarray, bt: jnp.ndarray, iters: int) -> jnp.ndarray:
    """Portable FISTA on feature-major inputs: Gt (r², n), bt (r, n) →
    simplex weights (r, n).  Same math as :func:`lae_weights_xla`
    (src/lae.cpp:97-130 semantics), transposed."""
    r, n = bt.shape
    G = Gt.reshape(r, r, n)

    L = jnp.max(jnp.sum(jnp.abs(G), axis=1), axis=0) + 1e-12   # Gershgorin, (n,)
    inv_L = (1.0 / L)[None, :]
    z0 = jnp.full_like(bt, 1.0 / r)

    def body(carry, _):
        z_prev, z_curr, d_prev, d_curr = carry
        alpha = (d_prev - 1.0) / d_curr
        v = z_curr + alpha * (z_curr - z_prev)
        grad = jnp.einsum("rn,rsn->sn", v, G, precision=PRECISION) - bt
        z_next = project_simplex((v - inv_L * grad).T).T
        d_next = (1.0 + jnp.sqrt(1.0 + 4.0 * d_curr * d_curr)) / 2.0
        return (z_curr, z_next, d_curr, d_next), None

    (_, z, _, _), _ = jax.lax.scan(
        body, (z0, z0, jnp.asarray(0.0, bt.dtype), jnp.asarray(1.0, bt.dtype)),
        None, length=iters,
    )
    return z


def lae_weights_xla(
    X: jnp.ndarray,
    anchors: jnp.ndarray,
    knn_idx: jnp.ndarray,
    iters: int = 150,
) -> jnp.ndarray:
    """The plain point-major reference the kernel and the feature-major scan
    are tested against: FISTA with momentum schedule matching the
    reference's delta recursion (src/lae.cpp:97-130); step size 1/L with L a
    Gershgorin upper bound on λmax(U_iU_iᵀ).
    """
    Ui = anchors[knn_idx]                       # (n, r, d)
    G = jnp.einsum("nrd,nsd->nrs", Ui, Ui, precision=PRECISION)  # (n, r, r) Gram
    b = jnp.einsum("nd,nrd->nr", X, Ui, precision=PRECISION)     # (n, r)

    # Gershgorin bound: λmax ≤ max_i Σ_j |G_ij|;  jitter guards degenerate rows.
    L = jnp.max(jnp.sum(jnp.abs(G), axis=-1), axis=-1) + 1e-12  # (n,)
    inv_L = (1.0 / L)[:, None]

    r = knn_idx.shape[1]
    z0 = jnp.full_like(b, 1.0 / r)

    def body(carry, _):
        z_prev, z_curr, d_prev, d_curr = carry
        alpha = (d_prev - 1.0) / d_curr
        v = z_curr + alpha * (z_curr - z_prev)
        grad = jnp.einsum("nr,nrs->ns", v, G, precision=PRECISION) - b
        z_next = project_simplex(v - inv_L * grad)
        d_next = (1.0 + jnp.sqrt(1.0 + 4.0 * d_curr * d_curr)) / 2.0
        return (z_curr, z_next, d_curr, d_next), None

    (_, z, _, _), _ = jax.lax.scan(
        body, (z0, z0, jnp.asarray(0.0, X.dtype), jnp.asarray(1.0, X.dtype)), None, length=iters
    )
    return z

"""Blocked LOBPCG eigensolver for large symmetric operators.

Replaces the host round-trip into RSpectra::eigs_sym that the reference's
Nyström/GLGP paths make (src/Fit.cpp:262-263, 410-411).  Sequential Lanczos
is latency-bound on an accelerator; LOBPCG does one operator application
per iteration on a whole (n, K) block — matvecs become matmuls —
and its Rayleigh-Ritz solve is a small (3K, 3K) eigh.

Soft-locking variant with Cholesky-QR orthonormalization (f32-safe via one
re-orthogonalization pass).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Tuple

import jax
import jax.numpy as jnp

from ..config import PRECISION


def _dot(a, b):
    return jnp.matmul(a, b, precision=PRECISION)

MatVec = Callable[[jnp.ndarray], jnp.ndarray]  # (n, k) -> (n, k)


def _chol_qr(X: jnp.ndarray) -> jnp.ndarray:
    """Orthonormalize columns by Cholesky-QR (twice for f32 robustness)."""
    for _ in range(2):
        G = _dot(X.T, X)
        G = G + 1e-9 * jnp.trace(G) / G.shape[0] * jnp.eye(G.shape[0], dtype=X.dtype)
        L = jnp.linalg.cholesky(G)
        X = jax.scipy.linalg.solve_triangular(L, X.T, lower=True).T
    return X


class LobpcgResult(NamedTuple):
    eigenvalues: jnp.ndarray   # (K,) descending
    eigenvectors: jnp.ndarray  # (n, K)
    residual_norms: jnp.ndarray


def lobpcg_standard(
    matvec: MatVec,
    X0: jnp.ndarray,
    iters: int = 60,
) -> LobpcgResult:
    """Largest-K eigenpairs of a symmetric operator.

    X0: (n, K) initial block (random normal is fine).  Fixed iteration count
    (static shapes for XLA); residual norms reported for observability.
    """
    n, k = X0.shape
    X = _chol_qr(X0)
    AX = matvec(X)
    P = jnp.zeros_like(X)
    AP = jnp.zeros_like(X)

    def body(carry, _):
        X, AX, P, AP = carry
        theta = jnp.sum(X * AX, axis=0)            # Rayleigh quotients
        R = AX - X * theta[None, :]

        # subspace S = [X, R, P]; first iteration has P = 0 — the Gram
        # regularization below keeps the Rayleigh-Ritz solvable regardless
        S = jnp.concatenate([X, R, P], axis=1)
        S = _chol_qr(S)
        AS = matvec(S)
        H = _dot(S.T, AS)
        H = 0.5 * (H + H.T)
        w, C = jnp.linalg.eigh(H)
        idx = jnp.argsort(-w)[:k]
        C = C[:, idx]
        X_new = _dot(S, C)
        AX_new = _dot(AS, C)
        # implicit P: component of the new X outside the old X span
        P_new = X_new - _dot(X, _dot(X.T, X_new))
        AP_new = AX_new - _dot(AX, _dot(X.T, X_new))
        res = jnp.linalg.norm(R, axis=0)
        return (X_new, AX_new, P_new, AP_new), res

    (X, AX, _, _), res_hist = jax.lax.scan(body, (X, AX, P, AP), None, length=iters)
    theta = jnp.sum(X * AX, axis=0)
    order = jnp.argsort(-theta)
    return LobpcgResult(theta[order], X[:, order], res_hist[-1][order])
